"""repro_torch.runtime — async deadline-aware serving runtime.

The port of ``repro.runtime``: the layer between the warmed serving core
(``repro_torch.serve``) and real traffic.  A bounded request queue with
cost-model admission control, a deadline-aware batch-closing scheduler
(EDF within priority tiers), a worker loop resolving a ``Future`` per
request through the bucket executables warmed by the micro-batcher (CUDA
graphs on the card), and an SLO metrics registry — all scheduled through
a swappable clock so every decision is deterministic under test.
"""

from repro_torch.runtime.clock import Clock, RealClock, VirtualClock
from repro_torch.runtime.loadgen import run_open_loop
from repro_torch.runtime.loop import RuntimeLoop, ServeRuntime
from repro_torch.runtime.metrics import (
    Histogram,
    MetricsRegistry,
    labeled,
    parse_labeled,
)
from repro_torch.runtime.queue import (
    AdmissionError,
    BucketEstimator,
    DeadlineExceededError,
    DeadlineInfeasibleError,
    FixedEstimator,
    QueueFullError,
    Request,
    RequestQueue,
    UnknownServableError,
)
from repro_torch.runtime.scheduler import (
    BatchProfile,
    BatchScheduler,
    ClosedBatch,
    WeightedFairPicker,
)

__all__ = [
    "Clock",
    "RealClock",
    "VirtualClock",
    "Histogram",
    "MetricsRegistry",
    "labeled",
    "parse_labeled",
    "AdmissionError",
    "QueueFullError",
    "DeadlineInfeasibleError",
    "DeadlineExceededError",
    "UnknownServableError",
    "Request",
    "RequestQueue",
    "BucketEstimator",
    "FixedEstimator",
    "BatchProfile",
    "BatchScheduler",
    "ClosedBatch",
    "WeightedFairPicker",
    "RuntimeLoop",
    "ServeRuntime",
    "run_open_loop",
]
