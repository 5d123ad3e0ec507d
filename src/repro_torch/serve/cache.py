"""Block-allocated (paged) KV cache with compressed storage codecs: the port
of the reference's ``serve/cache.py``.

The serving tier stores every layer's keys/values in a shared **pool** of
fixed-size pages, ``(num_pages, page_size, KV, D)`` per layer, instead of
one contiguous ring buffer per sequence. A per-slot **block table**
(``(max_slots, pages_per_slot)`` integers) maps each slot's logical pages
to physical pool pages, so sequences of different lengths share the pool
with no copies on admission or eviction (the vLLM layout, arXiv
2309.06180). Physical page 0 is reserved **scratch**: table entries beyond
a slot's allocation point at it, and attention masks everything it holds,
so freeing a slot is "return its pages, point its row at 0".

Storage is behind a **codec**, the serving counterpart of the grad-sync
``wire`` stage (``core/stages.py``), with its dtype menu and, for
``int8``, the same symmetric quantiser (``repro_torch.utils.quant``):

  float32            exact bytes: the paged path is bitwise the ring cache
  float16/bfloat16   2 bytes a value, cast on write, cast back on gather
  int8               1 byte a value + one float32 scale per (page slot,
                     kv head): a single-token write quantises only the
                     token it writes

Codecs expose ``init_entry`` / ``write_token`` / ``write_pages`` /
``gather``; the model's paged attention (``models.attention.
paged_decode_attention``) calls only ``write_token`` and ``gather``.

Where the reference returns new arrays, the port writes the pages in place
(``index_put_``); the write methods still return the entry, so the call
sites read as the reference's. Pools are built on an explicit device.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers, transformer
from repro_torch.utils import tree_leaves
from repro_torch.utils.quant import dequantize_q8, quantize_q8

# The deterministic subset of the wire dtypes: the KV cache and the
# grad-sync wire stage share the one quantiser (probquant is grad-sync only:
# a stochastic codec re-read every decode step would add fresh noise per
# read instead of a fixed rounding error).
KV_WIRE_DTYPES = ("float32", "float16", "bfloat16", "int8")

SCRATCH_PAGE = 0  # physical page 0: write target for inactive slots,
#                   gather target for unallocated table entries; masked.


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


class CastKVCodec:
    """Store pages as a (possibly narrower) float dtype; cast on gather.

    ``float32`` round-trips exactly (byte-identical to the ring cache);
    ``float16``/``bfloat16`` halve the pool at a bounded relative error.
    """

    def __init__(self, cfg, dtype):
        self.cfg = cfg
        self.name = str(dtype)
        self.store_dtype = layers.dtype_of(dtype)
        self.compute_dtype = layers.dtype_of(cfg.dtype)

    def init_entry(self, num_pages: int, page_size: int, *, device) -> dict:
        shape = (num_pages, page_size, self.cfg.num_kv_heads, self.cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.store_dtype, device=device),
                "v": torch.zeros(shape, dtype=self.store_dtype, device=device)}

    def write_token(self, entry, k_t, v_t, phys, offset):
        """Scatter one token per slot: k_t/v_t (S, KV, D) at
        (phys[i], offset[i])."""
        entry["k"][phys, offset] = k_t.to(self.store_dtype)
        entry["v"][phys, offset] = v_t.to(self.store_dtype)
        return entry

    def write_pages(self, entry, k_pages, v_pages, phys):
        """Scatter whole pages (prefill): k_pages/v_pages
        (n, page_size, KV, D) into physical pages ``phys`` (n,)."""
        entry["k"][phys] = k_pages.to(self.store_dtype)
        entry["v"][phys] = v_pages.to(self.store_dtype)
        return entry

    def gather(self, entry, tables):
        """(S, P) tables -> (k, v) each (S, P·page_size, KV, D) in the
        compute dtype, logical token order."""
        s = tables.shape[0]
        k = entry["k"][tables]  # (S, P, page_size, KV, D)
        v = entry["v"][tables]
        k = k.reshape(s, -1, *k.shape[3:]).to(self.compute_dtype)
        v = v.reshape(s, -1, *v.shape[3:]).to(self.compute_dtype)
        return k, v


class Int8KVCodec:
    """int8 pages + one float32 scale per (page slot, kv head).

    Each cached vector is quantised over its head_dim with the symmetric
    codec the ``int8`` grad-sync wire stage uses (``utils/quant.py``): the
    scale's granularity is the written vector, so a single-token decode
    write quantises only the token it writes.
    """

    name = "int8"

    def __init__(self, cfg):
        self.cfg = cfg
        self.compute_dtype = layers.dtype_of(cfg.dtype)

    def init_entry(self, num_pages: int, page_size: int, *, device) -> dict:
        kv, d = self.cfg.num_kv_heads, self.cfg.head_dim
        shape = (num_pages, page_size, kv, d)
        sshape = (num_pages, page_size, kv)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device)}

    def write_token(self, entry, k_t, v_t, phys, offset):
        qk, sk = quantize_q8(k_t)  # (S, KV, D), (S, KV)
        qv, sv = quantize_q8(v_t)
        entry["k"][phys, offset] = qk
        entry["k_scale"][phys, offset] = sk
        entry["v"][phys, offset] = qv
        entry["v_scale"][phys, offset] = sv
        return entry

    def write_pages(self, entry, k_pages, v_pages, phys):
        qk, sk = quantize_q8(k_pages)  # (n, ps, KV, D), (n, ps, KV)
        qv, sv = quantize_q8(v_pages)
        entry["k"][phys] = qk
        entry["k_scale"][phys] = sk
        entry["v"][phys] = qv
        entry["v_scale"][phys] = sv
        return entry

    def gather(self, entry, tables):
        s = tables.shape[0]
        k = dequantize_q8(entry["k"][tables], entry["k_scale"][tables],
                          dtype=self.compute_dtype)
        v = dequantize_q8(entry["v"][tables], entry["v_scale"][tables],
                          dtype=self.compute_dtype)
        k = k.reshape(s, -1, *k.shape[3:])
        v = v.reshape(s, -1, *v.shape[3:])
        return k, v


def make_kv_codec(name: str, cfg):
    """Codec for one wire dtype (the KV-cache side of the wire menu)."""
    if name == "int8":
        return Int8KVCodec(cfg)
    if name in ("float32", "float16", "bfloat16"):
        return CastKVCodec(cfg, name)
    raise ValueError(
        f"unknown KV wire dtype {name!r}; choose from {KV_WIRE_DTYPES}")


# ---------------------------------------------------------------------------
# Pool
# ---------------------------------------------------------------------------


def init_pool(cfg, codec, num_pages: int, page_size: int, *, device) -> dict:
    """Per-layer page pools on ``device`` mirroring ``transformer.init_cache``'s
    {"groups": (...), "tail": (...)} structure (the groups carry the leading
    ``n_groups`` stack dim), so ``transformer.decode_step`` walks it in place
    of the ring cache. Every layer's pages are their own zeroed storage."""
    pattern, n_groups, tail = transformer.pattern_info(cfg)
    types = set(pattern) | set(tail)
    if cfg.family not in ("dense", "moe") or types != {"attn"}:
        raise ValueError(
            "paged serving supports all-attention text families "
            f"(dense/moe); got family={cfg.family!r}, layer types "
            f"{sorted(types)}")

    def stack():
        one = codec.init_entry(num_pages, page_size, device=device)
        return {key: a.new_zeros((n_groups, *a.shape)) for key, a in one.items()}

    return {
        "groups": tuple(stack() for _ in pattern) if n_groups > 0 else (),
        "tail": tuple(codec.init_entry(num_pages, page_size, device=device) for _ in tail),
    }


def pool_bytes(pool) -> int:
    """Exact device footprint of a pool (payload + scales)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(pool))


def bytes_per_page(pool, num_pages: int) -> float:
    """Pool bytes per physical page across all layers: the unit the
    max-slots-per-memory-budget accounting is denominated in."""
    return pool_bytes(pool) / num_pages


# ---------------------------------------------------------------------------
# Allocator
# ---------------------------------------------------------------------------


class BlockAllocator:
    """Host-side physical-page free list. Page 0 is reserved scratch and
    is never handed out; double frees and frees of never-allocated pages
    raise. The free list's order is the reference's, so the same calls
    return the same pages."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least one non-scratch page")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, SCRATCH_PAGE, -1))
        self._live: set[int] = set()
        self.peak_live = 0  # high-water of simultaneously-live pages

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"out of KV pages: requested {n}, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        self._live.update(pages)
        if len(self._live) > self.peak_live:
            self.peak_live = len(self._live)
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p == SCRATCH_PAGE or p not in self._live:
                raise RuntimeError(f"invalid free of page {p}")
            self._live.discard(p)
            self._free.append(p)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._live)

    @property
    def live(self) -> frozenset[int]:
        return frozenset(self._live)
