"""Runtime subsystems: error policy and retries (``errors``), the shard
executors (``executor``), counters, manifests and the read ledger
(``manifest``), device-resident batches (``columnar``), telemetry
(``tracing``), the debug invariant mode (``debug``), the resilience
layer (``resilience``: hedged fetches, shard deadlines, the retry
budget, circuit breakers), live introspection (``introspect``), the
flight recorder (``flightrec``), the sampling profiler (``profiler``),
per-tenant SLOs (``slo``), the cluster rollup (``cluster``), process
identity (``multihost``), and the device service and write path
(imported by name: ``device_service``, ``device_write``)."""

from disq_tpu_torch.runtime.columnar import (  # noqa: F401
    ColumnarBatch,
    as_read_batch,
    concat_batches,
    resident_decode_enabled,
)
from disq_tpu_torch.runtime.counters import (  # noqa: F401
    PipelineCounters,
    ShardCounters,
    reduce_counters,
)
from disq_tpu_torch.runtime.debug import (  # noqa: F401
    check_read_batch,
    check_voffsets,
    debug_enabled,
)
from disq_tpu_torch.runtime.errors import (  # noqa: F401
    BreakerOpenError,
    CorruptBlockError,
    DeadlineExceededError,
    DisqOptions,
    ErrorPolicy,
    ShardErrorContext,
    ShardRetrier,
    TransientIOError,
    TruncatedReadError,
    WatchdogStallError,
    context_for_storage,
    is_transient,
)
from disq_tpu_torch.runtime.executor import (  # noqa: F401
    ExecutorStats,
    ShardPipelineExecutor,
    ShardResult,
    ShardTask,
    ShardWritePipeline,
    WriterStats,
    WriteShardResult,
    WriteShardTask,
    executor_for_storage,
    map_ordered_resumable,
    read_ledger_for_storage,
    run_write_stage,
    write_retrier_for_storage,
    writer_for_storage,
)
from disq_tpu_torch.runtime.resilience import (  # noqa: F401
    CircuitBreaker,
    HedgeController,
    ResilienceManager,
    RetryBudget,
    ShardDeadline,
    resilience_for_options,
    reset_resilience,
)
from disq_tpu_torch.runtime.cluster import (  # noqa: F401
    ClusterAggregator,
    parse_metrics_text,
)
from disq_tpu_torch.runtime.multihost import (  # noqa: F401
    process_count,
    process_id,
)
from disq_tpu_torch.runtime.introspect import (  # noqa: F401
    HEALTH,
    PipelineHealth,
    introspect_address,
    note_shard_counters,
    start_introspect_server,
    start_progress_log,
    stop_introspect_server,
    stop_progress_log,
)
from disq_tpu_torch.runtime.flightrec import (  # noqa: F401
    FlightRecorder,
    record_event,
    reset_flightrec,
    thread_stacks_text,
)
from disq_tpu_torch.runtime.profiler import (  # noqa: F401
    SamplingProfiler,
    active_profiler,
    profile_for,
    reset_profiler,
    start_profiler,
    stop_profiler,
)
from disq_tpu_torch.runtime.manifest import (  # noqa: F401
    QuarantineManifest,
    ReadLedger,
    StageManifest,
)
from disq_tpu_torch.runtime.tracing import (  # noqa: F401
    REGISTRY,
    MetricsRegistry,
    chrome_trace_events,
    count_transfer,
    counter,
    device_span,
    export_chrome_trace,
    gauge,
    gauge_report,
    hbm_resident,
    histogram,
    metrics_text,
    observe_gauge,
    phase_report,
    record_span,
    reset_telemetry,
    span,
    spans,
    start_span_log,
    stop_span_log,
    synced_timer,
    telemetry_snapshot,
    telemetry_summary,
    trace_phase,
    track_hbm,
    wrap_span,
)
