"""Serving runtime of the port: paged KV cache, radix prefix cache,
scheduler, draft proposers, telemetry, engine."""

from repro_torch.runtime.engine import (
    CANCELLED,
    FINISHED,
    RUNNING,
    STATS_SCHEMA,
    WAITING,
    Request,
    ServeEngine,
    chunked_cold_reference,
    dense_greedy_reference,
)
from repro_torch.runtime.paged_cache import (
    NULL_PAGE,
    POOL_DTYPES,
    QMAX,
    PageAllocator,
    dequantize_kv_page,
    gather_pages,
    gather_pages_dequant,
    init_paged_pool,
    is_quantized_dtype,
    paged_bytes,
    pool_dtype_name,
    quantize_kv_page,
    resolve_pool_dtype,
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
    "CANCELLED", "Counter", "DEFAULT_TENANT", "DRAFTERS", "DraftProposer", "FCFSPolicy",
    "FINISHED", "Gauge", "Histogram", "MetricsRegistry", "MixedPolicy", "NULL_PAGE",
    "NgramProposer", "NumericsProbe", "POLICIES", "POOL_DTYPES",
    "PRIORITY_CLASSES",
    "PageAllocator", "QMAX", "RUNNING", "RadixPrefixCache", "Request",
    "RequestView", "SJFPolicy", "STATS_SCHEMA", "SchedulerPolicy",
    "ServeEngine", "StepTracer", "Telemetry", "TenantQuota",
    "TenantQuotaPolicy", "TraceEvent", "WAITING",
    "aggregate_snapshots", "chunked_cold_reference",
    "dense_greedy_reference", "dequantize_kv_page", "gather_pages",
    "gather_pages_dequant", "get_drafter", "get_scheduler", "init_paged_pool",
    "is_quantized_dtype", "paged_bytes", "pool_dtype_name",
    "quantize_kv_page", "resolve_pool_dtype",
]
