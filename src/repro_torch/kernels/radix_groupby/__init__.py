from .ops import radix_groupby
from .ref import radix_groupby_ref

__all__ = ["radix_groupby", "radix_groupby_ref"]
