"""Time-attribution report over a Chrome-trace / Perfetto JSON file.

    python -m repro_torch.obs.report trace.json [--json]

Folds the trace's complete spans into a per-run breakdown:

- **category totals** — compute vs transfer vs wait vs overhead, computed as
  SELF time (each span's duration minus its children's on the same thread),
  so a fused kernel nested inside its component's compute span is never
  double-counted and the ``execute`` phase's uncovered remainder surfaces as
  coordination *overhead*;
- **per-component table** — self compute time, kernel time, calls, rows in,
  for every component seen in ``compute``/``kernel`` spans;
- **wait sites** — total blocked time per wait kind (channel put/get/drain,
  admission gate, activity busy-wait);
- **transfer summary** — h2d/d2h crossing counts + bytes;
- **training spans** — in a training trace (``launch/train.py`` under
  ``REPRO_TRACE=1``), each span of the ``train``, ``model`` and ``data``
  categories by name: calls, total and self time (these categories also
  join the category totals).

Instant events (cache copies, arena acquire/release) are counted, not
timed.  With ``--json`` the same structure is printed as JSON for tooling.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Dict, List

#: span categories folded into the attribution classes (phase self time is
#: the run's coordination overhead)
_CATEGORY_CLASS = {"compute": "compute", "kernel": "compute",
                   "transfer": "transfer", "wait": "wait",
                   "phase": "overhead", "train": "train", "model": "model",
                   "data": "data"}
#: the training path's categories, tabled span by span
_TRAINING = ("train", "model", "data")


def _self_times(spans: List[dict]) -> List[dict]:
    """Annotate each complete span with ``self_us``: its duration minus the
    duration of child spans nested within it on the same (pid, tid) track.
    Spans are properly nested per track (begin/end discipline), so a scan
    with a stack suffices."""
    by_track: Dict[tuple, List[dict]] = defaultdict(list)
    for ev in spans:
        by_track[(ev.get("pid", 0), ev.get("tid", 0))].append(ev)
    for track in by_track.values():
        # outer spans first at equal start time
        track.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack: List[dict] = []
        for ev in track:
            ev["self_us"] = ev.get("dur", 0.0)
            end = ev["ts"] + ev.get("dur", 0.0)
            while stack and ev["ts"] >= stack[-1]["_end"] - 1e-9:
                stack.pop()
            if stack:
                stack[-1]["self_us"] -= ev.get("dur", 0.0)
            ev["_end"] = end
            stack.append(ev)
    return spans


def analyze(payload: dict) -> dict:
    """Fold one trace payload into the attribution structure (one entry per
    pid/run)."""
    events = payload.get("traceEvents", payload if isinstance(payload, list)
                         else [])
    runs_meta = (payload.get("otherData", {}).get("runs", [])
                 if isinstance(payload, dict) else [])
    by_pid: Dict[int, List[dict]] = defaultdict(list)
    for ev in events:
        by_pid[ev.get("pid", 0)].append(ev)

    out_runs = []
    for pid in sorted(by_pid):
        evs = by_pid[pid]
        spans = _self_times([e for e in evs if e.get("ph") == "X"])
        categories: Dict[str, float] = defaultdict(float)
        components: Dict[str, dict] = {}
        waits: Dict[str, float] = defaultdict(float)
        transfers: Dict[str, dict] = {}
        named: Dict[str, dict] = {}
        counts: Dict[str, int] = defaultdict(int)
        wall_us = 0.0
        for ev in spans:
            cat = ev.get("cat", "")
            cls = _CATEGORY_CLASS.get(cat)
            if cls:
                categories[cls] += max(ev["self_us"], 0.0)
            if cat == "phase" and ev["name"] == "execute":
                wall_us = max(wall_us, ev.get("dur", 0.0))
            if cat in ("compute", "kernel"):
                args = ev.get("args") or {}
                name = args.get("component", ev["name"])
                c = components.setdefault(
                    name, {"compute_us": 0.0, "kernel_us": 0.0,
                           "calls": 0, "rows_in": 0})
                if cat == "kernel":
                    c["kernel_us"] += ev.get("dur", 0.0)
                else:
                    c["compute_us"] += max(ev["self_us"], 0.0)
                    c["calls"] += 1
                    c["rows_in"] += int(args.get("rows_in",
                                                 args.get("rows", 0)) or 0)
            elif cat in _TRAINING:
                t = named.setdefault(ev["name"],
                                     {"calls": 0, "us": 0.0, "self_us": 0.0})
                t["calls"] += 1
                t["us"] += ev.get("dur", 0.0)
                t["self_us"] += max(ev["self_us"], 0.0)
            elif cat == "wait":
                waits[ev["name"]] += ev.get("dur", 0.0)
            elif cat == "transfer":
                t = transfers.setdefault(ev["name"],
                                         {"count": 0, "bytes": 0, "us": 0.0})
                t["count"] += 1
                t["bytes"] += int((ev.get("args") or {}).get("bytes", 0))
                t["us"] += ev.get("dur", 0.0)
        for ev in evs:
            if ev.get("ph") == "i":
                counts[f"{ev.get('cat')}.{ev.get('name')}"] += 1
        meta = runs_meta[pid - 1] if 0 < pid <= len(runs_meta) else {}
        out_runs.append({
            "pid": pid, "meta": meta, "wall_us": wall_us,
            "categories": dict(categories),
            "components": components,
            "waits": dict(waits),
            "transfers": transfers,
            "instants": dict(counts),
        })
        if named:
            out_runs[-1]["spans"] = named
    return {"runs": out_runs}


def _fmt_us(us: float) -> str:
    return f"{us / 1e3:10.2f}ms"


def render(result: dict) -> str:
    lines: List[str] = []
    for run in result["runs"]:
        meta = run["meta"]
        label = meta.get("flow", f"run {run['pid']}")
        detail = "/".join(str(meta[k]) for k in ("engine", "backend")
                          if meta.get(k))
        rid = str(meta.get("run_id", ""))[:8]
        lines.append(f"== {label}" + (f" [{detail}]" if detail else "")
                     + (f" run_id={rid}" if rid else "") + " ==")
        cats = run["categories"]
        total = sum(cats.values()) or 1.0
        lines.append("  category        self-time      share")
        for cls in ("compute", "transfer", "wait", "overhead") + tuple(
                c for c in _TRAINING if c in cats):
            us = cats.get(cls, 0.0)
            lines.append(f"  {cls:<12}{_fmt_us(us)}   {us / total:7.1%}")
        if run["wall_us"]:
            lines.append(f"  execute-phase wall: {run['wall_us'] / 1e3:.2f}ms")
        if run["components"]:
            lines.append("  component                          compute"
                         "       kernel   calls     rows_in")
            for name, c in sorted(run["components"].items(),
                                  key=lambda kv: -kv[1]["compute_us"]):
                lines.append(
                    f"  {name[:32]:<32}{_fmt_us(c['compute_us'])}"
                    f" {_fmt_us(c['kernel_us'])}"
                    f"  {c['calls']:6d}  {c['rows_in']:10d}")
        if run.get("spans"):
            lines.append("  span                    calls        total"
                         "         self")
            for name, t in sorted(run["spans"].items(),
                                  key=lambda kv: -kv[1]["us"]):
                lines.append(f"  {name[:22]:<22}{t['calls']:7d} "
                             f"{_fmt_us(t['us'])} {_fmt_us(t['self_us'])}")
        if run["waits"]:
            lines.append("  wait site                blocked")
            for name, us in sorted(run["waits"].items(), key=lambda kv: -kv[1]):
                lines.append(f"  {name:<22}{_fmt_us(us)}")
        if run["transfers"]:
            lines.append("  transfer   count        bytes         time")
            for name, t in sorted(run["transfers"].items()):
                lines.append(f"  {name:<8}{t['count']:8d} {t['bytes']:12d}"
                             f" {_fmt_us(t['us'])}")
        if run["instants"]:
            inst = ", ".join(f"{k}={v}" for k, v in
                             sorted(run["instants"].items()))
            lines.append(f"  instants: {inst}")
        lines.append("")
    return "\n".join(lines)


def main(argv: List[str] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    as_json = "--json" in args
    paths = [a for a in args if a != "--json"]
    if len(paths) != 1:
        print("usage: python -m repro_torch.obs.report <trace.json> [--json]")
        return 2
    with open(paths[0]) as f:
        payload = json.load(f)
    result = analyze(payload)
    if not result["runs"]:
        print(f"report: no trace events in {paths[0]}")
        return 1
    print(json.dumps(result, indent=2) if as_json else render(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
