"""Metadata store (§2): schema info of sources and processing components,
dataflow specifications, job/task planning info.  Import/export XML (as the
paper's implementation used) and JSON."""
from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

from .graph import Dataflow
from .partitioner import ExecutionTreeGraph

#: EngineRun.spec scalar fields serialized as XML attributes, with the
#: coercion applied on import (everything is a string in XML)
_RUN_INT_FIELDS = ("copies", "bytes_copied", "h2d_transfers", "h2d_bytes",
                   "d2h_transfers", "d2h_bytes", "dispatch_calls",
                   "arena_hits", "arena_misses", "arena_bytes_reused",
                   "shards")
_RUN_FLOAT_FIELDS = ("wall_time",)
_RUN_STR_FIELDS = ("engine", "backend", "run_id", "created", "git_sha",
                   "trace_file")


def _children(root, tag: str) -> list:
    """Children of ``root``'s ``tag`` element, or none when it is absent.
    Tested with ``is not None``: an element with no children is falsy, and
    its truth value is deprecated."""
    el = root.find(tag)
    return list(el) if el is not None else []


class MetadataStore:
    def __init__(self) -> None:
        self.component_specs: Dict[str, Dict[str, str]] = {}
        self.dataflows: Dict[str, dict] = {}
        self.partitions: Dict[str, dict] = {}
        self.runtime_plans: Dict[str, dict] = {}
        #: per-flow observed component statistics (core/optimizer.py)
        self.statistics: Dict[str, dict] = {}
        #: per-flow adaptive-optimization record: statistics snapshot, the
        #: applied rewrites, and the BEFORE (static) / AFTER (rewritten)
        #: partitionings + runtime plans side by side
        self.adaptive: Dict[str, dict] = {}
        #: per-flow instrumentation of the LAST engine run (EngineRun.spec):
        #: wall time, copies, h2d/d2h transfer counts+bytes, dispatch calls,
        #: CacheArena hit/miss/bytes-reused — the per-run cache statistics
        self.runs: Dict[str, dict] = {}

    # ----------------------------------------------------------- register
    def register_flow(self, flow: Dataflow) -> None:
        for name, comp in flow.vertices.items():
            self.component_specs[name] = comp.spec()
        self.dataflows[flow.name] = {
            "name": flow.name,
            "vertices": [comp.spec() for comp in flow.vertices.values()],
            "edges": [list(e) for e in flow.edges],
        }

    def register_partitioning(self, flow: Dataflow,
                              g_tau: ExecutionTreeGraph) -> None:
        self.partitions[flow.name] = {
            "trees": [{"id": t.tree_id, "root": t.root, "members": t.members}
                      for t in g_tau.trees],
            "edges": [list(e) for e in g_tau.edges],
        }

    def register_runtime_plan(self, flow: Dataflow, plan) -> None:
        """Record the executor sizing plan (pool width, per-edge channel
        depths + cache-size estimates) chosen for a run of ``flow``."""
        self.runtime_plans[flow.name] = plan.spec()

    def register_statistics(self, flow: Dataflow, stats) -> None:
        """Record the observed per-component statistics (rows in/out,
        selectivity, per-row time, cache bytes) collected by a calibration
        prefix or harvested from a prior run (``FlowStatistics.spec``)."""
        self.statistics[flow.name] = stats.spec()

    def register_run(self, flow: Dataflow, run) -> None:
        """Record one engine run's scalar instrumentation
        (``EngineRun.spec``): wall time, copy/transfer counters and the
        CacheArena reuse statistics attributed to that run."""
        self.runs[flow.name] = run.spec()

    @staticmethod
    def _partition_spec(g_tau) -> dict:
        return {
            "trees": [{"id": t.tree_id, "root": t.root, "members": t.members}
                      for t in g_tau.trees],
            "edges": [list(e) for e in g_tau.edges],
        }

    def register_adaptive(self, flow: Dataflow, *, stats, rewrites,
                          before_partition, before_plan,
                          after_partition, after_plan) -> None:
        """Record one adaptive (optimize_level=2) planning round: what was
        measured, which rewrites were applied, and the static-vs-rewritten
        partitioning + runtime plan side by side."""
        self.adaptive[flow.name] = {
            "statistics": stats.spec(),
            "rewrites": [r.spec() for r in rewrites],
            "before": {"partition": self._partition_spec(before_partition),
                       "plan": before_plan.spec()},
            "after": {"partition": self._partition_spec(after_partition),
                      "plan": after_plan.spec()},
        }

    def type_of(self, component_name: str) -> Optional[str]:
        spec = self.component_specs.get(component_name)
        return spec["type"] if spec else None

    # ---------------------------------------------------------------- XML
    def to_xml(self) -> str:
        root = ET.Element("metadata")
        comps = ET.SubElement(root, "components")
        for spec in self.component_specs.values():
            ET.SubElement(comps, "component", attrib=spec)
        flows = ET.SubElement(root, "dataflows")
        for df in self.dataflows.values():
            f = ET.SubElement(flows, "dataflow", attrib={"name": df["name"]})
            for e in df["edges"]:
                ET.SubElement(f, "edge", attrib={"src": e[0], "dst": e[1]})
        parts = ET.SubElement(root, "partitions")
        for name, p in self.partitions.items():
            pf = ET.SubElement(parts, "partition", attrib={"dataflow": name})
            for t in p["trees"]:
                ET.SubElement(pf, "tree", attrib={
                    "id": str(t["id"]), "root": t["root"],
                    "members": ",".join(t["members"])})
            for e in p["edges"]:
                ET.SubElement(pf, "tree-edge",
                              attrib={"src": str(e[0]), "dst": str(e[1])})
        runs = ET.SubElement(root, "runs")
        for name, spec in self.runs.items():
            attrib = {"dataflow": name}
            for k in _RUN_STR_FIELDS + _RUN_INT_FIELDS + _RUN_FLOAT_FIELDS:
                v = spec.get(k)
                if v is not None:       # None (e.g. no git repo) => omitted
                    attrib[k] = str(v)
            if spec.get("shard_rows"):
                # per-shard source row counts of a sharded run
                attrib["shard_rows"] = ",".join(
                    str(n) for n in spec["shard_rows"])
            r = ET.SubElement(runs, "run", attrib=attrib)
            for rw in spec.get("rewrites", []):
                ET.SubElement(r, "rewrite",
                              attrib={k: str(v) for k, v in rw.items()})
            for rf in spec.get("refusals", []):
                ET.SubElement(r, "refusal",
                              attrib={k: str(v) for k, v in rf.items()})
            metrics = spec.get("metrics")
            if metrics:
                # nested counters/gauges/histograms: carried as JSON text
                m = ET.SubElement(r, "metrics")
                m.text = json.dumps(metrics, sort_keys=True)
        return ET.tostring(root, encoding="unicode")

    @classmethod
    def from_xml(cls, text: str) -> "MetadataStore":
        store = cls()
        root = ET.fromstring(text)
        for c in _children(root, "components"):
            store.component_specs[c.attrib["name"]] = dict(c.attrib)
        for f in _children(root, "dataflows"):
            store.dataflows[f.attrib["name"]] = {
                "name": f.attrib["name"],
                "vertices": [],
                "edges": [[e.attrib["src"], e.attrib["dst"]] for e in f],
            }
        for pf in _children(root, "partitions"):
            store.partitions[pf.attrib["dataflow"]] = {
                "trees": [{"id": int(t.attrib["id"]), "root": t.attrib["root"],
                           "members": t.attrib["members"].split(",")}
                          for t in pf if t.tag == "tree"],
                "edges": [[int(e.attrib["src"]), int(e.attrib["dst"])]
                          for e in pf if e.tag == "tree-edge"],
            }
        for r in _children(root, "runs"):
            spec: dict = {}
            for k in _RUN_STR_FIELDS:
                if k in r.attrib:
                    spec[k] = r.attrib[k]
            for k in _RUN_INT_FIELDS:
                if k in r.attrib:
                    spec[k] = int(r.attrib[k])
            for k in _RUN_FLOAT_FIELDS:
                if k in r.attrib:
                    spec[k] = float(r.attrib[k])
            if "shard_rows" in r.attrib:
                spec["shard_rows"] = [int(n) for n in
                                      r.attrib["shard_rows"].split(",")]
            spec.setdefault("git_sha", None)
            spec.setdefault("trace_file", None)
            spec["rewrites"] = [dict(ch.attrib) for ch in r
                                if ch.tag == "rewrite"]
            spec["refusals"] = [dict(ch.attrib) for ch in r
                                if ch.tag == "refusal"]
            m = r.find("metrics")
            spec["metrics"] = json.loads(m.text) if m is not None else {}
            store.runs[r.attrib["dataflow"]] = spec
        return store

    # --------------------------------------------------------------- JSON
    def to_json(self) -> str:
        return json.dumps({"components": self.component_specs,
                           "dataflows": self.dataflows,
                           "partitions": self.partitions,
                           "runtime_plans": self.runtime_plans,
                           "statistics": self.statistics,
                           "adaptive": self.adaptive,
                           "runs": self.runs}, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "MetadataStore":
        store = cls()
        d = json.loads(text)
        store.component_specs = d.get("components", {})
        store.dataflows = d.get("dataflows", {})
        store.partitions = d.get("partitions", {})
        store.runtime_plans = d.get("runtime_plans", {})
        store.statistics = d.get("statistics", {})
        store.adaptive = d.get("adaptive", {})
        store.runs = d.get("runs", {})
        return store
