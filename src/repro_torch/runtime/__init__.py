"""Runtime of the port: the serving side (paged KV cache, radix prefix
cache, scheduler, draft proposers, telemetry, engine) and the training
loop's fault tolerance."""

from repro_torch.runtime.engine import (
    CANCELLED,
    FINISHED,
    ROUTING_MODES,
    RUNNING,
    STATS_SCHEMA,
    WAITING,
    EngineReplicaGroup,
    Request,
    ServeEngine,
    chunked_cold_reference,
    dense_greedy_reference,
)
from repro_torch.runtime.fault_tolerance import (
    FaultTolerantLoop,
    StragglerMonitor,
    elastic_mesh_shape,
)
from repro_torch.runtime.paged_cache import (
    NULL_PAGE,
    POOL_DTYPES,
    QMAX,
    PageAllocator,
    capture_pages,
    dequantize_kv_page,
    gather_pages,
    gather_pages_dequant,
    init_paged_pool,
    is_quantized_dtype,
    model_axis_size,
    paged_bytes,
    paged_bytes_per_device,
    pool_dtype_name,
    pool_model_sharded,
    pool_shardings,
    quantize_kv_page,
    resolve_pool_dtype,
    restore_pages,
    sharded_pool_device_bytes,
    touched_pages,
)
from repro_torch.runtime.prefix_cache import RadixPrefixCache
from repro_torch.runtime.scheduler import (
    DEFAULT_TENANT,
    POLICIES,
    PRIORITY_CLASSES,
    FCFSPolicy,
    MixedPolicy,
    RequestView,
    SchedulerPolicy,
    SJFPolicy,
    TenantQuota,
    TenantQuotaPolicy,
    get_scheduler,
)
from repro_torch.runtime.spec_decode import (
    DRAFTERS,
    DraftProposer,
    NgramProposer,
    get_drafter,
)
from repro_torch.runtime.telemetry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NumericsProbe,
    StepTracer,
    Telemetry,
    TraceEvent,
    aggregate_snapshots,
)

__all__ = [
    "CANCELLED", "Counter", "DEFAULT_TENANT", "DRAFTERS", "DraftProposer",
    "EngineReplicaGroup", "FCFSPolicy", "FaultTolerantLoop", "FINISHED",
    "Gauge", "Histogram", "MetricsRegistry", "MixedPolicy", "NULL_PAGE",
    "NgramProposer", "NumericsProbe", "POLICIES", "POOL_DTYPES",
    "PRIORITY_CLASSES", "PageAllocator", "QMAX", "ROUTING_MODES", "RUNNING",
    "RadixPrefixCache", "Request", "RequestView", "SJFPolicy", "STATS_SCHEMA",
    "SchedulerPolicy", "ServeEngine", "StepTracer", "StragglerMonitor",
    "Telemetry", "TenantQuota", "TenantQuotaPolicy", "TraceEvent", "WAITING",
    "aggregate_snapshots", "capture_pages", "chunked_cold_reference",
    "dense_greedy_reference", "dequantize_kv_page", "elastic_mesh_shape",
    "gather_pages", "gather_pages_dequant", "get_drafter", "get_scheduler",
    "init_paged_pool", "is_quantized_dtype", "model_axis_size", "paged_bytes",
    "paged_bytes_per_device", "pool_dtype_name", "pool_model_sharded",
    "pool_shardings", "quantize_kv_page", "resolve_pool_dtype",
    "restore_pages", "sharded_pool_device_bytes", "touched_pages",
]
