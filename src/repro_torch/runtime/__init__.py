"""Serving runtime of the port: paged KV cache, scheduler, engine."""

from repro_torch.runtime.engine import (
    Request,
    ServeEngine,
    chunked_cold_reference,
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
from repro_torch.runtime.scheduler import (
    FCFSPolicy,
    RequestView,
    SchedulerPolicy,
    get_scheduler,
)

__all__ = [
    "FCFSPolicy", "NULL_PAGE", "POOL_DTYPES", "PageAllocator", "QMAX",
    "Request", "RequestView", "SchedulerPolicy", "ServeEngine",
    "chunked_cold_reference", "dequantize_kv_page", "gather_pages",
    "gather_pages_dequant", "get_scheduler", "init_paged_pool",
    "is_quantized_dtype", "paged_bytes", "pool_dtype_name",
    "quantize_kv_page", "resolve_pool_dtype",
]
