"""Serving runtime of the port: paged KV cache, scheduler, engine."""

from repro_torch.runtime.engine import (
    Request,
    ServeEngine,
    chunked_cold_reference,
)
from repro_torch.runtime.paged_cache import (
    NULL_PAGE,
    PageAllocator,
    gather_pages,
    init_paged_pool,
    paged_bytes,
)
from repro_torch.runtime.scheduler import (
    FCFSPolicy,
    RequestView,
    SchedulerPolicy,
    get_scheduler,
)

__all__ = [
    "FCFSPolicy", "NULL_PAGE", "PageAllocator", "Request", "RequestView",
    "SchedulerPolicy", "ServeEngine", "chunked_cold_reference",
    "gather_pages", "get_scheduler", "init_paged_pool", "paged_bytes",
]
