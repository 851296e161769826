from .components import (Aggregate, ArraySource, CollectSink, Converter,
                         DimTable, Expression, FileSink, Filter,
                         FusedExpression, FusedSegment, Lookup, Merge,
                         Project, Sort, Splitter, Union)
from .queries import BUILDERS, QueryFlow, build_q1, build_q2, build_q3, build_q4
from .ssb import SSBData, generate, mfgr_id, region_id

__all__ = [
    "Aggregate", "ArraySource", "CollectSink", "Converter", "DimTable",
    "Expression", "FileSink", "Filter", "FusedExpression", "FusedSegment",
    "Lookup", "Merge", "Project", "Sort",
    "Splitter", "Union", "BUILDERS", "QueryFlow",
    "build_q1", "build_q2", "build_q3", "build_q4",
    "SSBData", "generate", "mfgr_id", "region_id",
]
