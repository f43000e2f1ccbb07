"""repro_torch.serve: continuous-batching inference engine over a paged KV
cache (the port of ``repro.serve``).

A :class:`ServeEngine` owns params + a fixed-capacity paged KV cache and
runs one decode step over a slot-based batch -- requests join via
prefill-into-free-slots and leave on EOS / max-new.
"""
from repro_torch.serve.engine import ServeEngine, default_buckets
from repro_torch.serve.kvcache import (TRASH_PAGE, BlockAllocator,
                                       PageGeometry, cache_bytes,
                                       default_geometry, init_paged_cache,
                                       paged_cache_shapes, supports)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = [
    "ServeEngine", "default_buckets",
    "TRASH_PAGE", "BlockAllocator", "PageGeometry", "cache_bytes",
    "default_geometry", "init_paged_cache", "paged_cache_shapes",
    "supports",
    "Request", "Scheduler",
]
