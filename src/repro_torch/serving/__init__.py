"""Serving substrate: the multi-tier LM engine bank, per-tier micro-batch
queues and the replica-pool scheduler, the SkewRoute dispatcher running
the fused skew-metrics fast path, admission control, and the pipeline
wiring dispatch → queues → tier runners → streaming recalibration
together."""

from repro_torch.serving.engine import (  # noqa: F401
    EngineBank,
    GenerationResult,
    LMEngine,
    make_engine,
)
from repro_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    AdmissionSpec,
)
from repro_torch.serving.pipeline import (  # noqa: F401
    ExecutedBatch,
    PipelineTelemetry,
    ServingPipeline,
)
from repro_torch.serving.router_service import (  # noqa: F401
    BatchDispatchResult,
    DispatchRecord,
    DispatcherStats,
    SkewRouteDispatcher,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    MicroBatchQueue,
    Replica,
    Request,
    TierScheduler,
)
