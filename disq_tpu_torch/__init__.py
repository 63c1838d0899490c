"""disq_tpu_torch — the PyTorch/CUDA port of ``disq_tpu``.

The same storages, datasets and outputs as the JAX package, with every
device kernel written by hand for NVIDIA Hopper (``csrc/``) and the rest
as torch ops or host code. It never imports ``jax`` or ``disq_tpu``.
"""

__version__ = "0.1.0"

from disq_tpu_torch.api import (  # noqa: F401
    BaiWriteOption,
    CraiWriteOption,
    FileCardinalityWriteOption,
    FleetHandle,
    Interval,
    ReadsDataset,
    ReadsFormatWriteOption,
    ReadsStorage,
    SbiWriteOption,
    ServeHandle,
    StageManifestWriteOption,
    TabixIndexWriteOption,
    TempPartsDirectoryWriteOption,
    TraversalParameters,
    ValidationStringency,
    VariantsDataset,
    VariantsFormatWriteOption,
    VariantsStorage,
    WriteOption,
    serve,
    serve_fleet,
)
from disq_tpu_torch.runtime import (  # noqa: F401
    BreakerOpenError,
    ClusterAggregator,
    ColumnarBatch,
    CoordinatorLostError,
    CorruptBlockError,
    DeadlineExceededError,
    DisqOptions,
    ErrorPolicy,
    PipelineCounters,
    QuarantineManifest,
    ReadLedger,
    ShardCounters,
    StageManifest,
    WatchdogStallError,
    device_span,
    introspect_address,
    metrics_text,
    phase_report,
    process_count,
    process_id,
    reduce_counters,
    span,
    start_introspect_server,
    start_span_log,
    stop_introspect_server,
    stop_span_log,
    synced_timer,
    telemetry_snapshot,
    telemetry_summary,
    trace_phase,
)
