"""Counter-based keyed draws: the port's random bits for the keyed
compression stages (the random-k mask, the probquant wire's keep draws,
the Hadamard rotation's ±1 diagonal).

A draw is a pure function of a key chain (seed, round, leaf, client) and
the element's index within its leaf: each link folds one counter into a
32-bit hash with MurmurHash3's finaliser, so every (key, index) pair has
its own bits and distinct indices of one key never collide. The arithmetic
is uint32 emulated in int64: a product is split into 16-bit halves so it
never overflows, and every step is masked to 32 bits. Integer operations
are exact, so the CPU and the card give the same bits, and the draws of a
whole ``[k, N]`` stack are a fixed number of elementwise ops, whatever
the leaf and client counts.

The streams are not ``jax.random``'s (the port does not reproduce those);
the parity tests feed the stages JAX's draws instead.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import to_device

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
_INC = 0x6D2B79F5  # keeps an all-zero chain (seed 0, counters 0) off the hash 0


def mul32(x, c: int):
    """(x · c) mod 2³² for x in [0, 2³²) (a Python int or an int64 tensor)
    and a constant c < 2³². Each half-product stays below 2⁴⁸."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def mix32(h):
    """MurmurHash3's 32-bit finaliser (a bijection on [0, 2³²))."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def fold(h, c):
    """Fold counter ``c`` into key ``h``: for a fixed key, a bijection of the
    counter's low 32 bits. Ints or int64 tensors (broadcasting)."""
    return mix32(((mul32(h, _GOLDEN) + _INC) & M32) ^ (c & M32))


def key(seed: int, *counters: int) -> int:
    """The key of the chain seed → counters, on the host."""
    h = mix32((seed + _INC) & M32)
    for c in counters:
        h = fold(h, c)
    return h


def leaf_keys(layout, seed: int, *counters: int, clients: torch.Tensor | None = None):
    """The key of every leaf i of ``layout``, seed → counters → i, as int64
    ``[L]`` on the layout's device (i the leaf's number, ``leaf_ids``: its
    place in the tree a one-leaf layout was cut from); with ``clients``
    (int ``[k]`` ids on that device) folded last, ``[k, L]``."""
    keys = to_device(np.asarray([key(seed, *counters, i) for i in layout.leaf_ids],
                                np.int64), layout.device)
    if clients is not None:
        keys = fold(keys[None, :], clients.to(torch.int64)[:, None])
    return keys


# Columns past which a layout's draws are made segment by segment (the
# cached positions are two int64 [N] tensors).
SEGMENT_LIMIT = 1 << 27


def element_hashes(layout, keys: torch.Tensor) -> torch.Tensor:
    """Every column's hash: its leaf's key (``[..., L]``) folded with its
    index in the leaf -> int64 ``[..., N]``. On a layout of pieces cut over
    a group (``FlatLayout.over`` with boxes) the index is the whole leaf's,
    so each piece draws its entries' bits of the whole leaf's draws. That,
    and a layout past ``SEGMENT_LIMIT`` columns, is made segment by
    segment, holding no ``[N]`` index tensor (the same bits)."""
    if layout.cut or layout.total > SEGMENT_LIMIT:
        return torch.cat([fold(keys[..., i:i + 1], layout.whole_index(i))
                          for i in range(layout.num_leaves)], dim=-1)
    return fold(layout.expand(keys), layout.positions()[1])


def uniform(h: torch.Tensor) -> torch.Tensor:
    """A float32 uniform in [0, 1) from the hash's top 24 bits (exact)."""
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def rademacher(h: torch.Tensor) -> torch.Tensor:
    """A float32 ±1 from the hash's top bit."""
    return 1.0 - 2.0 * (h >> 31).to(torch.float32)
