"""SLO forensics: lifecycle tracing, fleet telemetry, miss attribution.

Zero-overhead-when-off observability for the serving stack (ISSUE 8).
Enable by attaching a :class:`Timeline` to the request trace *before*
serving::

    from repro_torch.obs import attach_timeline, collect_attribution, dump_run

    attach_timeline(trace)            # engine/router/fabric now stamp
    fm = fabric.serve_trace(trace)
    report = collect_attribution(trace)          # why requests missed
    dump_run("traces/", "myrun", trace, fabric.nodes,
             horizon_ms=cfg.horizon_ms,
             migration_events=fm.migration_events)   # Perfetto + JSONL

With no timeline attached every layer pays one ``is None`` branch per
batch/dispatch — the golden suites pin byte-identical results and the
bench smoke pins the wall budget.  The engine's typed span records
(``spans``) are governed separately by ``EngineConfig.event_log``, as
before.
"""
from repro_torch.obs.attribution import (COMPONENTS, attribution_arrays,
                                   collect_attribution)
from repro_torch.obs.export import dump_run, export_chrome_trace
from repro_torch.obs.sampler import sample_fleet, write_jsonl
from repro_torch.obs.spans import (SPAN_KINDS, ApplySpan, BatchSpan, DecodeSpan,
                             DropSpan, PreemptSpan, TickSpan)
from repro_torch.obs.timeline import (CAUSE_COMPLETED, CAUSE_DROP_DEADLINE,
                                CAUSE_DROP_PARENT, CAUSE_DROP_REPLAY,
                                CAUSE_DROP_SHUTDOWN, CAUSE_LOST,
                                CAUSE_NAMES, CAUSE_NONE, CAUSE_SHED,
                                Timeline, attach_timeline)


def __getattr__(name):
    # lazy: keeps ``python -m repro.obs.validate`` free of the runpy
    # already-in-sys.modules warning
    if name == "validate_dir":
        from repro_torch.obs.validate import validate_dir
        return validate_dir
    raise AttributeError(name)

__all__ = [
    "COMPONENTS", "attribution_arrays", "collect_attribution",
    "dump_run", "export_chrome_trace", "sample_fleet", "write_jsonl",
    "SPAN_KINDS", "ApplySpan", "BatchSpan", "DecodeSpan", "DropSpan",
    "PreemptSpan", "TickSpan", "CAUSE_NAMES", "CAUSE_NONE",
    "CAUSE_COMPLETED", "CAUSE_DROP_DEADLINE", "CAUSE_DROP_SHUTDOWN",
    "CAUSE_SHED", "CAUSE_LOST", "CAUSE_DROP_REPLAY", "CAUSE_DROP_PARENT",
    "Timeline", "attach_timeline", "validate_dir",
]
