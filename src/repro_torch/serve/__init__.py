"""Serving tier: paged compressed KV cache + continuous batching, the port
of the reference's ``repro.serve``.

``repro_torch.serve.cache`` owns the storage (page pool, wire-dtype
codecs, block allocator); ``repro_torch.serve.engine`` owns the scheduling
(admission queue, slot management, a decode loop that reads nothing back
from the device). The compute lives in ``repro_torch.dist.step``
(``make_paged_prefill_step`` / ``make_paged_serve_step``) and
``repro_torch.models.attention.paged_decode_attention``.
"""

from repro_torch.serve.cache import (
    KV_WIRE_DTYPES,
    BlockAllocator,
    bytes_per_page,
    init_pool,
    make_kv_codec,
    pool_bytes,
)
from repro_torch.serve.engine import Completion, Request, ServeConfig, ServeEngine

__all__ = [
    "KV_WIRE_DTYPES",
    "BlockAllocator",
    "Completion",
    "Request",
    "ServeConfig",
    "ServeEngine",
    "bytes_per_page",
    "init_pool",
    "make_kv_codec",
    "pool_bytes",
]
