"""Observability: contextvar-scoped tracing (Chrome-trace/Perfetto export)
a per-run metrics registry that reconciles exactly with ``CacheStats``, and
the ``python -m repro_torch.obs.report`` time-attribution CLI.

Enable per run with ``REPRO_TRACE=1`` (file at ``REPRO_TRACE_PATH``, default
``repro_trace.json``) or programmatically:

    from repro_torch.obs import trace
    with trace.trace_scope() as tracer:
        engine.run()
    tracer.events            # raw span/instant/counter events
    tracer.metrics.snapshot()
"""
from .metrics import Histogram, MetricsRegistry
from .trace import (Tracer, active, export_run, git_sha, iso_now, new_run_id,
                    run_scope, span, trace_scope)

__all__ = [
    "Histogram", "MetricsRegistry", "Tracer", "active", "export_run",
    "git_sha", "iso_now", "new_run_id", "run_scope", "span", "trace_scope",
]
