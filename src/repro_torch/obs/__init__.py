"""Engine observability: tracing, structured metrics, online auto-tuning
(the port of ``repro.obs``).

* ``tracing``  — ``phase_scope`` ranges (NVTX, the paper's Nsight ranges)
  threaded through ``core/pic.py``, ``distributed/engine.py`` and
  ``distributed/halo.py``, and the span recorder behind them (on inside
  ``recording()`` or a profiler capture: ``record_function`` twins and
  spans with host and device times, read by ``spans()``);
  ``trace_session`` capture around a run (``pic_run --profile-dir``) and
  ``trace_scope_names`` to read the ranges back;
* ``metrics``  — a structured per-step metrics stream (JSONL run report +
  in-memory ring) of what the engine computes: queue occupancy/skew,
  migration/birth/emission overflows, free-slot-ring occupancy, in-flight
  pending rows, host wall time per step. ``EngineConfig.metrics`` adds the
  ring counters (diagnostics-only: the state is bitwise identical with the
  toggle on or off);
* ``autotune`` — an online controller that consumes the metrics stream
  between steps and retunes ``async_n`` / ``max_migration`` /
  ``max_births`` / ``rebalance_every`` / ``rebalance_skew`` (imported
  lazily — ``repro_torch.obs.autotune`` — so the engine can depend on the
  tracing and metrics layers without a cycle).
"""

from repro_torch.obs.metrics import (MetricsStream, StepMetrics,
                                     atomic_write_json, read_jsonl,
                                     validate_record)
from repro_torch.obs.tracing import (capture_scopes, phase_scope,
                                     trace_scope_names, trace_session)

__all__ = [
    "MetricsStream", "StepMetrics", "atomic_write_json", "read_jsonl",
    "validate_record", "capture_scopes", "trace_scope_names",
    "phase_scope", "trace_session",
]
