"""Count-sketch gradient compression (FetchSGD, Rothchild et al. 2020), a
port of the JAX package's ``core/sketch.py``: the comparison baseline
whose server keeps momentum and error feedback in sketch space.

A count sketch S ∈ R^{rows×cols} summarises an n-vector: coordinate i
goes to column h_r(i) of row r with sign s_r(i). Sketches are linear, so
the server sums client sketches. ``_hash`` and ``_sign`` are the
reference's uint32 multiplicative hashes, emulated in int64 (the product
split into 16-bit halves, ``utils/draws.py: mul32``), so every column and
sign is bitwise JAX's.

The columns and signs depend only on (n, rows, cols), so they are made
once per (n, rows, cols, device), with each row's coordinates stably
sorted by column into a ``[rows, B, cols]`` table (B the fullest
bucket's size, short buckets padded with a zero entry). ``sketch`` then
sums each bucket one slot at a time, in ascending coordinate order: the
order of JAX's scatter-add on the CPU, with no atomics, so a sketch is
bitwise the same on every run and device (CUDA's atomic ``index_add_``
would sum in a varying order).

Those tables hold several int64 ``[rows, n]`` arrays: tens of GB at a
language model's size. A layout cut over a group (each rank holding
pieces of leaves, ``FlatLayout.over`` with boxes), or one past
``TABLE_LIMIT`` table entries, takes the ``*_pieces`` path instead: each
segment's columns and signs hashed from its entries' whole-tree indices
(``FlatLayout.tree_index``) in chunks, never held. ``sketch_pieces`` sums
the entries that count on this rank into each bucket with ``index_add_``
(on the CPU in ascending index order, so an uncut layout's sketch is the
table path's bit for bit; on the card in the atomics' order) and all-reduces
the partial sketches over the group. ``hitters_pieces`` un-sketches the
rank's own entries and takes the whole model's top k by a radix select
over the group (``sparsify.group_kth_largest``), ties to the lower whole
index as ``heavy_hitters``' stable sort takes them. A tree of mixed dtypes
(``GroupedLayout``) always takes the pieces path: one sketch of the whole
tree, each group's entries hashed by their whole-tree indices, summed in
tree order (so on the CPU it is the float32 tree's sketch, bit for bit),
and its hitters come back per group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed

from repro_torch.utils.draws import M32, mul32

_PRIME = 2_654_435_761  # Knuth's multiplicative constant

# (n, rows, cols, device) -> the layout's column, sign and bucket tables
_TABLES: dict = {}
# rows · n past which a sketch hashes its entries chunk by chunk (the tables'
# int64 [rows, n] arrays would pass 1 GiB each)
TABLE_LIMIT = 1 << 27
_CHUNK = 1 << 24  # entries hashed at once on the pieces path


def _hash(idx: torch.Tensor, seed: int, mod: int) -> torch.Tensor:
    """Column of each index (int64 in [0, 2³²)) in row ``seed``: int64 in [0, mod)."""
    salt = (seed * 0x9E3779B9 + 1) & M32
    h = mul32((idx + salt) & M32, _PRIME)
    h = h ^ (h >> 16)
    return h % mod


def _sign(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """±1 (float32) of each index in row ``seed``."""
    salt = (seed * 0x85EBCA6B + 7) & M32
    h = mul32((idx + salt) & M32, _PRIME)
    return torch.where(((h >> 15) & 1) == 1, 1.0, -1.0).to(torch.float32)


def _depth(n: int, rows: int, cols: int) -> int:
    """The deepest bucket of the tables of ``n`` entries: the hashes of
    ``_hash`` on the host (numpy int64, the same integer operations), a
    chunk of entries at a time, so the table's shape is known without a read
    of the device."""
    counts = np.zeros((rows, cols), np.int64)
    for lo in range(0, n, _CHUNK):
        idx = np.arange(lo, min(n, lo + _CHUNK), dtype=np.int64)
        for r in range(rows):
            counts[r] += np.bincount(_hash(idx, r, cols), minlength=cols)
    return int(counts.max())


def _tables(n: int, rows: int, cols: int, device):
    """(columns [rows, n], signs [rows, n], bucket index table [rows, B, cols]
    (n marks an empty slot), the signs in the same table)."""
    key = (n, rows, cols, str(device))
    if key not in _TABLES:
        idx = torch.arange(n, dtype=torch.int64, device=device)
        col = torch.stack([_hash(idx, r, cols) for r in range(rows)])
        sgn = torch.stack([_sign(idx, r) for r in range(rows)])
        order = torch.sort(col, dim=1, stable=True).indices  # each bucket in index order
        col_sorted = torch.gather(col, 1, order)
        counts = torch.zeros(rows, cols, dtype=torch.int64, device=device).scatter_add_(
            1, col, torch.ones_like(col))
        depth = _depth(n, rows, cols)
        starts = torch.cumsum(counts, dim=1) - counts
        slot = idx[None, :] - torch.gather(starts, 1, col_sorted)
        at = (torch.arange(rows, device=device)[:, None] * depth + slot) * cols + col_sorted
        bucket_idx = torch.full((rows * depth * cols,), n, dtype=torch.int64, device=device)
        bucket_sgn = torch.zeros(rows * depth * cols, dtype=torch.float32, device=device)
        bucket_idx[at.reshape(-1)] = order.reshape(-1)
        bucket_sgn[at.reshape(-1)] = torch.gather(sgn, 1, order).reshape(-1)
        _TABLES[key] = (col, sgn, bucket_idx.view(rows, depth, cols),
                        bucket_sgn.view(rows, depth, cols))
    return _TABLES[key]


def sketch(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Count-sketch each row of ``x`` (``[k, n]``, or one ``[n]`` vector):
    S[r, c] = Σ_{i: h_r(i)=c} s_r(i)·x_i -> ``[k, rows, cols]`` (``[rows,
    cols]``), each bucket summed in ascending i."""
    one = x.dim() == 1
    xs = x.reshape(1, -1) if one else x
    n = xs.shape[1]
    _, _, bucket_idx, bucket_sgn = _tables(n, rows, cols, x.device)
    ext = torch.cat([xs.float(), xs.new_zeros(xs.shape[0], 1, dtype=torch.float32)], dim=1)
    out = torch.zeros(xs.shape[0], rows, cols, dtype=torch.float32, device=x.device)
    for b in range(bucket_idx.shape[1]):
        out += ext[:, bucket_idx[:, b]] * bucket_sgn[:, b]
    return out[0] if one else out


def unsketch(s: torch.Tensor, n: int) -> torch.Tensor:
    """Median-of-rows estimate of every coordinate -> ``[n]``. The median is
    ``jnp.median``'s: the mean of the two middle values (``(lo + hi) · 0.5``)
    when ``rows`` is even, where ``torch.median`` returns the lower one."""
    rows, cols = s.shape
    col, sgn, _, _ = _tables(n, rows, cols, s.device)
    est = torch.gather(s.float(), 1, col) * sgn
    ordered = torch.sort(est, dim=0).values
    return (ordered[(rows - 1) // 2] + ordered[rows // 2]) * 0.5


def heavy_hitters(s: torch.Tensor, n: int, k: int):
    """The top-k coordinates of the sketch's estimate by magnitude -> (values
    ``[k]``, indices ``[k]``, dense ``[n]``). Ties go to the lower index, as
    ``lax.top_k``'s do (a stable descending sort; ``torch.topk`` promises
    no order)."""
    est = unsketch(s, n)
    idxs = torch.sort(torch.abs(est), descending=True, stable=True).indices[:k]
    vals = est[idxs]
    dense = torch.zeros(n, dtype=torch.float32, device=s.device).index_copy_(0, idxs, vals)
    return vals, idxs, dense


def by_pieces(layout, rows: int) -> bool:
    """Whether ``layout``'s sketches take the ``*_pieces`` path: its leaves
    are cut over a group, or the tables would pass ``TABLE_LIMIT``, or it
    is a tree of mixed dtypes (``GroupedLayout``, whose entries hash by
    their whole-tree indices across its groups)."""
    return layout.groups is not None or layout.cut or rows * layout.full_total > TABLE_LIMIT


def _leaves(layout, x):
    """(the layout of leaf j's group, its place there, its segment of
    ``x``) for every leaf j in tree order that counts on this rank: ``x``
    one ``[..., N]`` stack of a ``FlatLayout``, or one per dtype group of a
    ``GroupedLayout`` (a group whose leaves are not cut, in a tree whose
    others are, counts on the group of ranks' first rank)."""
    if layout.groups is None:
        for i, (seg, counted) in enumerate(zip(layout.segments(x), layout.counted,
                                               strict=True)):
            if counted:
                yield layout, i, seg
        return
    segs = [sub.segments(xg) for sub, xg in zip(layout.groups, x, strict=True)]
    first = layout.group is None or torch.distributed.get_rank(layout.group) == 0
    for g, p in layout.where:
        sub = layout.groups[g]
        if sub.counted[p] if sub.cut else first:
            yield sub, p, segs[g][p]


def _chunks(layout, x):
    """(a chunk of leaf j's segment of ``x``, the chunk's whole-tree
    indices) over the leaves that count on this rank, in tree order,
    ``_CHUNK`` entries at a time."""
    for sub, i, seg in _leaves(layout, x):
        idx = sub.tree_index(i)
        for a in range(0, idx.shape[0], _CHUNK):
            yield seg[..., a:a + _CHUNK], idx[a:a + _CHUNK]


def sketch_pieces(x, layout, rows: int, cols: int) -> torch.Tensor:
    """``sketch`` of each row of a flat ``[k, N]`` stack of ``layout`` (one
    stack per dtype group of a ``GroupedLayout``), as the sketch of the
    whole tree's float32 rows -> ``[k, rows, cols]``: the entries that count
    on this rank hashed by their whole-tree indices and summed into their
    buckets in tree order, the partial sketches summed over the group."""
    first = x if isinstance(x, torch.Tensor) else x[0]
    out = torch.zeros(first.shape[0], rows, cols, dtype=torch.float32, device=first.device)
    for chunk, idx in _chunks(layout, x):
        for r in range(rows):
            out[:, r].index_add_(1, _hash(idx, r, cols), chunk.float() * _sign(idx, r))
    if layout.cut:
        torch.distributed.all_reduce(out, group=layout.group)
    return out


def unsketch_pieces(s: torch.Tensor, layout) -> torch.Tensor:
    """``unsketch`` at the rank's entries of ``layout`` (each hashed by its
    whole-tree index) -> ``[N]``, the rank's piece of the whole tree's
    estimate."""
    rows, cols = s.shape
    out = []
    for i in range(layout.num_leaves):
        idx = layout.tree_index(i)
        for a in range(0, idx.shape[0], _CHUNK):
            at = idx[a:a + _CHUNK]
            est = torch.stack([s[r].float()[_hash(at, r, cols)] * _sign(at, r)
                               for r in range(rows)])
            ordered = torch.sort(est, dim=0).values
            out.append((ordered[(rows - 1) // 2] + ordered[rows // 2]) * 0.5)
    return torch.cat(out) if out else s.new_zeros(0)


def hitters_pieces(s: torch.Tensor, layout, k: int):
    """``heavy_hitters``' dense ``[N]`` at the rank's entries of ``layout``
    (float32; one ``[N_g]`` per dtype group of a ``GroupedLayout``): the
    whole tree's k largest estimates by magnitude (those above the k-th
    largest magnitude T, then those equal to T with the lowest whole-tree
    indices), found by radix selects over the group, no estimate
    gathered."""
    from repro_torch.core.sparsify import group_kth_largest, tree_counted

    subs = (layout,) if layout.groups is None else layout.groups
    group = layout.group if layout.cut else None
    counted = lambda x, sub: tree_counted(x, sub, group)  # noqa: E731
    est = [unsketch_pieces(s, sub) for sub in subs]
    mag = [torch.abs(e)[None] for e in est]
    one = lambda n: torch.full((1,), n, dtype=torch.int64, device=s.device)  # noqa: E731
    thr = group_kth_largest([counted(m, sub).contiguous().view(torch.int32)
                             for m, sub in zip(mag, subs, strict=True)], one(k),
                            31, group).to(torch.int32).view(torch.float32)
    above = sum(torch.count_nonzero(counted(m > thr, sub))
                for m, sub in zip(mag, subs, strict=True)).reshape(1)
    if group is not None:
        torch.distributed.all_reduce(above, group=group)
    # the ties at T: the (k - above) lowest whole-tree indices among them, as
    # the largest keys 2^B - index (the others' key 0)
    bits = max(1, (layout.full_total - 1).bit_length())
    index = [torch.cat([sub.tree_index(i) for i in range(sub.num_leaves)])[None]
             for sub in subs]
    tied = [m == thr for m in mag]
    keys = [torch.where(t, (1 << bits) - i, 0) for t, i in zip(tied, index, strict=True)]
    last = (1 << bits) - group_kth_largest([counted(x, sub) for x, sub in
                                            zip(keys, subs, strict=True)],
                                           one(k) - above, bits + 1, group)
    out = tuple(torch.where((m > thr) | (t & (i <= last)), e[None], 0.0)[0]
                for m, t, i, e in zip(mag, tied, index, est, strict=True))
    return out[0] if layout.groups is None else out
