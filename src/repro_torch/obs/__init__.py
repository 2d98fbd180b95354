"""repro_torch.obs — end-to-end request tracing, telemetry export, and
measured-latency feedback into the planner.

Three pieces:

* :mod:`repro_torch.obs.trace` — ``Tracer`` / ``Trace`` / ``Span``: one
  structured trace per served request, clocked by ``runtime.clock``
  (deterministic under ``VirtualClock``), with ``CollectiveLedger``
  records adopted as span events; and ``phase``, the forward's and the
  registry's phases as child spans and ``torch.profiler`` ranges.
* :mod:`repro_torch.obs.export` — registry snapshots + drained spans as
  JSON and Prometheus text exposition.
* :mod:`repro_torch.obs.feedback` — ``PlanFeedback``: per-(bucket, plan)
  execute-latency EWMAs that ``plan.autoplan.choose_plan`` consults
  before the modeled ``DeviceModel`` costs.
"""

from repro_torch.obs.export import (
    render_prometheus,
    render_traces_json,
    traces_to_dicts,
    write_metrics_json,
    write_prometheus,
    write_traces_json,
)
from repro_torch.obs.feedback import (
    PlanFeedback,
    bucket_key,
    plan_key,
    plan_key_from_plan,
)
from repro_torch.obs.trace import (
    Span,
    SpanEvent,
    Trace,
    Tracer,
    current_span,
    engine_batch_info,
    install_ledger_listener,
    phase,
    plan_attributes,
    start_layer_span,
    use_span,
)

__all__ = [
    "Span",
    "SpanEvent",
    "Trace",
    "Tracer",
    "current_span",
    "use_span",
    "plan_attributes",
    "engine_batch_info",
    "start_layer_span",
    "install_ledger_listener",
    "phase",
    "PlanFeedback",
    "bucket_key",
    "plan_key",
    "plan_key_from_plan",
    "traces_to_dicts",
    "render_traces_json",
    "write_traces_json",
    "write_metrics_json",
    "render_prometheus",
    "write_prometheus",
]
