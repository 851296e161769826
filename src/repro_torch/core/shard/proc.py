"""Process route: shard passes in spawned worker processes.

The parent pickles one payload per shard — the flow with ONLY that
shard's source partition installed (scatter, never a full-table
broadcast), plus the run options — and ships it to a persistent
spawn-context ``ProcessPoolExecutor``.  Each worker rebuilds its own
backend / execution-tree graph / runtime plan (exactly the engine's
setup sequence), runs the full per-shard flow with cuts in ``partial``
mode, and returns a pickled dict::

    {"agg": ..., "generic": ...,   # ShardContext stashes (merge.py)
     "sinks": {name: [(split_index, columns, n), ...]},
     "stats": {...},               # the worker's exact CacheStats snapshot
     "rows": int,                  # source rows this shard processed
     "dispatch": int,              # component dispatches on its flow copy
     "launches": {kernel: n},      # kernel launches the worker made
     "seconds": {step: s}}         # unpickle, setup, execute

or ``{"error": {"kind", "msg"}}`` — errors cross the process boundary as
``faults.classify`` kinds rather than pickled exceptions, and the parent
re-raises the matching fault class so transient worker failures escalate
to whole-shard replay just like the inline route.

Scope rules: contextvar-scoped fault plans and tracers cannot follow
work into another process, so ``ShardRunner`` degrades process→inline
whenever either is active.  Workers additionally drop ``REPRO_FAULTS``
from their environment — a child re-parsing the env plan would keep its
own injection counts and fire extra faults the parent's plan never
recorded; under the process route, faults inject at the parent's
``shard`` site only.

Payloads carry host numpy rows only: the pickler refuses a
``torch.Tensor`` anywhere in a payload (a flow holding one degrades to
inline, recorded), and DimTable device caches and compiled segment
runners are dropped by their components' ``__getstate__``.

On the ``torch`` backend every worker opens its own CUDA context on the
same card and loads the kernel library that the parent built before the
pool started (``_load_kernels``), so no worker runs ``nvcc``.  A library
that cannot be built raises; it is never a reason to go inline.

The pool is module-global and reused across runs (spawning workers —
and importing torch inside them — is far too slow to pay per run) and is
shut down at interpreter exit, or by ``close_pool``.
"""
from __future__ import annotations

import atexit
import io
import os
import pickle
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, List, Optional

import torch

from .. import config, faults


class ProcessRouteUnavailable(RuntimeError):
    """The worker pool cannot run shard passes (e.g. it broke mid-run);
    the caller falls back to the inline route."""


_POOL: Optional[ProcessPoolExecutor] = None
_POOL_WIDTH = 0


def _get_pool(width: int) -> ProcessPoolExecutor:
    global _POOL, _POOL_WIDTH
    if _POOL is None or _POOL_WIDTH < width:
        if _POOL is not None:
            _POOL.shutdown(wait=True)
        import multiprocessing as mp
        _POOL = ProcessPoolExecutor(max_workers=width,
                                    mp_context=mp.get_context("spawn"))
        _POOL_WIDTH = width
    return _POOL


def _drop_pool() -> None:
    global _POOL, _POOL_WIDTH
    if _POOL is not None:
        _POOL.shutdown(wait=False, cancel_futures=True)
        _POOL = None
        _POOL_WIDTH = 0


def close_pool() -> None:
    """Shut the worker pool down and wait for its processes to exit."""
    global _POOL, _POOL_WIDTH
    if _POOL is not None:
        _POOL.shutdown(wait=True)
        _POOL = None
        _POOL_WIDTH = 0


atexit.register(_drop_pool)


class _HostPickler(pickle.Pickler):
    """Pickles a payload of host data: a ``torch.Tensor`` anywhere in it
    raises, so no device tensor crosses to a worker."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            raise TypeError("a shard payload must hold host arrays only, "
                            "not a torch.Tensor")
        return NotImplemented


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _load_kernels(backend) -> None:
    """Build (or load) the CUDA kernel library in the parent before a
    worker starts, so the workers only load it: concurrent builds would
    each run ``nvcc``.  Its ``RuntimeError`` propagates."""
    device = getattr(backend, "device", None)
    if device is not None and device.type == "cuda":
        from ...kernels import _cuda
        _cuda.library()


# --------------------------------------------------------------- parent side
def build_payloads(flow, options, plan, parts) -> Optional[List[bytes]]:
    """One pickled ``(flow-with-slice, options, cuts, k)`` per shard, or
    ``None`` when the flow cannot be pickled (lambda-configured
    components etc.) — the caller degrades to the inline route."""
    sources = [(name, flow.component(name)) for name in plan.sources]
    orig = {name: comp.columns for name, comp in sources}
    try:
        payloads = []
        for k in range(plan.shards):
            for name, comp in sources:
                comp.set_data(parts[k][name])
            payloads.append(_dumps((flow, options, list(plan.cuts), k)))
        return payloads
    except Exception:
        return None
    finally:
        for name, comp in sources:
            comp.set_data(orig[name])


def _rebuild_error(err: Dict[str, str]) -> BaseException:
    # permanent application errors surface as the ORIGINAL exception type —
    # a KeyError in a worker must reach the caller as a KeyError, exactly
    # like the serial engine; transients stay wrapped so the parent retry
    # loop classifies them deterministically even when they don't pickle
    if err.get("kind") != "transient" and err.get("exc") is not None:
        try:
            return pickle.loads(err["exc"])
        except Exception:
            pass
    cls = {"transient": faults.TransientFault,
           "poison": faults.PoisonFault}.get(err.get("kind"),
                                             faults.PermanentFault)
    return cls(err.get("msg", "shard worker failed"))


def run_passes(flow, payloads: List[bytes], ctx, res,
               backend=None) -> List[dict]:
    """Run every shard payload on the worker pool; per-shard transient
    failures (injected at the parent's ``shard`` fault site, or classified
    out of the worker) replay that one shard.  Stashes are only absorbed
    from successful results, so a failed attempt needs no rollback."""
    _load_kernels(backend)
    width = min(len(payloads), max(1, (os.cpu_count() or 2) - 1))
    try:
        pool = _get_pool(width)
        futures = {k: pool.submit(_shard_worker, p)
                   for k, p in enumerate(payloads)}
    except BrokenProcessPool as e:
        _drop_pool()
        raise ProcessRouteUnavailable(str(e)) from e
    out: List[dict] = [None] * len(payloads)
    for k in sorted(futures):
        fut = futures[k]
        attempt, delay = 0, config.retry_backoff()
        while True:
            try:
                faults.inject("shard", component=flow.name, split=k)
                result = pickle.loads(fut.result())
                err = result.get("error")
                if err is not None:
                    raise _rebuild_error(err)
                out[k] = result
                break
            except BrokenProcessPool as e:
                _drop_pool()
                raise ProcessRouteUnavailable(str(e)) from e
            except BaseException as e:
                if (faults.classify(e) != "transient"
                        or attempt >= config.retry_max()):
                    raise
                faults.record_retry(f"shard.{flow.name}.{k}", attempt, delay)
                res.replays += 1
                if delay > 0.0:
                    time.sleep(delay)
                delay = min(delay * 2.0 if delay else 0.0,
                            faults.RETRY_BACKOFF_CAP_S)
                attempt += 1
                try:
                    fut = pool.submit(_shard_worker, payloads[k])
                except BrokenProcessPool as e2:
                    _drop_pool()
                    raise ProcessRouteUnavailable(str(e2)) from e2
    return out


# --------------------------------------------------------------- worker side
def _shard_worker(payload: bytes) -> bytes:
    """Run one shard pass in a worker process (module-level: spawn needs
    an importable reference).  Mirrors ``OptimizedEngine.run``'s setup:
    resolve backend → assign → partition → plan_runtime → execute."""
    os.environ.pop("REPRO_FAULTS", None)     # see module docstring
    t0 = time.perf_counter()
    try:
        flow, options, cuts, k = pickle.loads(payload)
        t_load = time.perf_counter()
        from ..backend import resolve_backend
        from ..engine import _assign_backend
        from ..executor import StreamingExecutor
        from ..partitioner import partition
        from ..planner import plan_runtime
        from ...kernels import launch_counts
        from ..shared_cache import cache_stats_scope
        from .merge import ShardContext

        bk = resolve_backend(options.backend)
        _assign_backend(flow, bk)
        g_tau = partition(flow)
        m_prime = options.pipeline_degree or options.num_splits
        runtime_plan = plan_runtime(
            flow, g_tau,
            num_splits=options.num_splits, m_prime=m_prime,
            mt_threads=options.mt_threads, cores=options.cores,
            pool_width=options.pool_width,
            channel_capacity=options.channel_capacity,
            streaming=options.streaming and options.concurrent_trees,
            backend=bk)
        shard_ctx = ShardContext()
        shard_ctx.begin_pass(k)
        for name in cuts:
            comp = flow.component(name)
            comp.shard_role = "partial"
            comp._shard_ctx = shard_ctx
        launched = launch_counts()
        t_setup = time.perf_counter()
        with cache_stats_scope() as stats:
            executor = StreamingExecutor(flow, g_tau, options, runtime_plan)
            try:
                executor.execute()
            finally:
                executor.shutdown()
            sinks: Dict[str, list] = {}
            for sname in flow.sinks():
                sink = flow.component(sname)
                sinks[sname] = [(c.split_index, c.to_dict(), c.n)
                                for c in sink.drain()]
            agg, generic = shard_ctx.export()
            snap = stats.snapshot()
        t_exec = time.perf_counter()
        rows = sum(flow.component(s).total_rows() for s in flow.sources())
        # component dispatch counts live on the worker's flow copy; ship
        # them so the parent run's dispatch_calls covers shard-pass work
        dispatch = sum(c.calls for c in flow.vertices.values())
        launches = {name: n - launched[name]
                    for name, n in launch_counts().items()
                    if n != launched[name]}
        out = {"agg": agg, "generic": generic, "sinks": sinks,
               "stats": snap, "rows": rows, "dispatch": dispatch,
               "launches": launches,
               "seconds": {"unpickle": t_load - t0,
                           "setup": t_setup - t_load,
                           "execute": t_exec - t_setup}}
        return _dumps(out)
    except BaseException as e:
        try:    # ship the exception itself when it pickles (see _rebuild_error)
            exc = pickle.dumps(e, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            exc = None
        return pickle.dumps(
            {"error": {"kind": faults.classify(e),
                       "msg": f"{type(e).__name__}: {e}", "exc": exc}},
            protocol=pickle.HIGHEST_PROTOCOL)
