"""Partition specs for the production trainer and server (every model
family): the port of the reference's ``dist/sharding.py``.

Layout policy (Megatron-style TP + optional FSDP over ``data``), the
reference's rules verbatim:

* **Tensor parallel** (``model`` axis): column-parallel first matmuls
  (wq/wk/wv, mlp gate/up, ssm in_proj, rglru gate/rec projections, the
  unembedding) shard their *output* feature dim; row-parallel second
  matmuls (wo, mlp down, out_proj) shard their *input* feature dim; the
  embedding table and MoE experts shard the vocab / expert dim.
* **FSDP** (``data`` axis, only when ``dist.step.needs_fsdp``): the *other*
  big dim of each matrix is sharded over ``data``.
* Anything 1-D (norm scales, biases, per-channel gates) and anything whose
  dim does not divide the mesh axis is replicated on that dim.

Scanned layer stacks (``params["layers"]``) carry a leading
position-in-pattern stack dim that is never sharded; the rules apply to the
trailing dims. The port's parameter trees name their leaves as the
reference's do, so the rules apply by leaf name.

A spec is a ``P``: a tuple-like of entries, one per tensor dim, each an
axis name, a tuple of axis names or ``None`` (``tuple(spec)`` equals the
reference's ``tuple(PartitionSpec)``, a one-name tuple normalised to the
name as JAX does). The functions read a mesh only through its axis names and
sizes, so they take a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``.

``named_shardings`` gives, per leaf, a ``NamedSharding``: the mesh, the
spec and the DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh
dim). A tree laid over a mesh is held as each rank's local piece:
``local_tree`` cuts whole leaves into pieces (``distribute_tensor(...)
.to_local()``, no collective: every rank holds the whole) and
``full_tree`` gathers them back (``DTensor.from_local(...).full_tensor()``,
a collective).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.launch.mesh import axis_size, mesh_axes
from repro_torch.utils import tree_leaves, tree_map
from repro_torch.utils.flat import Box

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")  # data-parallel axes, outermost first


class P:
    """A partition spec: one entry per tensor dim (an axis name, a tuple
    of them, or ``None``), trailing dims replicated."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


def dp_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is laid out over (pod outermost)."""
    return tuple(a for a in DATA_AXES if a in mesh_axes(mesh))


def _axis_ok(mesh, axis: str | None, dim: int) -> str | None:
    """``axis`` if present in the mesh and ``dim`` divides it, else None."""
    if axis is None or mesh is None or axis not in mesh_axes(mesh):
        return None
    if dim % axis_size(mesh, axis) != 0:
        return None
    return axis


def _dp_ok(mesh, dp: tuple[str, ...], dim: int) -> tuple[str, ...] | None:
    """``dp`` if ``dim`` divides the product of the dp axes' sizes, else
    None (long-context decode with global batch 1 replicates the batch
    dim instead of failing the data axis)."""
    if not dp:
        return None
    size = 1
    for a in dp:
        size *= axis_size(mesh, a)
    return dp if dim % size == 0 else None


def _map_named(fn, tree, names=()):
    """``fn(names, leaf)`` over the tensors of ``tree``, ``names`` the dict
    keys on the leaf's path (sequence indices and NamedTuple fields are not
    names, as in the reference's ``_leaf_names``)."""
    if isinstance(tree, torch.Tensor):
        return fn(list(names), tree)
    if isinstance(tree, dict):
        return {k: _map_named(fn, tree[k], names + (k,)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, x, names) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(fn, x, names) for x in tree)
    raise TypeError(f"a spec tree mirrors a tree of tensors, got a {type(tree).__name__} leaf")


# (model-sharded dim, fsdp-sharded dim) counted from the right, per leaf
# name (within its parent module). Missing names → fully replicated.
_TP_RULES: dict[str, tuple[int, int]] = {
    # embeddings: vocab → model, d_model → data
    "table": (-2, -1),
    "kernel": (-1, -2),          # unembed (d, V); audio (K, d, V)
    # attention
    "wq": (-1, -2), "wk": (-1, -2), "wv": (-1, -2),
    "wo": (-2, -1),
    # SwiGLU MLP
    "gate": (-1, -2), "up": (-1, -2), "down": (-2, -1),
    # MoE experts: expert dim → model (EP), expert d_ff → data (FSDP),
    # matching moe.moe_ep's w_specs.
    "w_gate": (-3, -1), "w_up": (-3, -1), "w_down": (-3, -2),
    # RG-LRU / SSM projections
    "gate_proj": (-1, -2), "rec_proj": (-1, -2),
    "in_proj": (-1, -2), "out_proj": (-2, -1),
}

# conv kernels are (width, channels): tiny, keep replicated. Routers stay
# replicated (they are fp32 and feed a lax.top_k).
_REPLICATED = {"router", "conv", "bq", "bk", "bv", "bias", "scale",
               "w_a", "b_a", "w_x", "b_x", "lam", "A_log", "D", "dt_bias"}


def _spec_for_leaf(names: list[str], shape, mesh, *, fsdp: bool) -> P:
    stacked = 1 if (names and names[0] == "layers") else 0
    logical = shape[stacked:]
    nd = len(logical)
    leaf = names[-1] if names else ""
    if "conv" in names:  # depthwise conv kernels are tiny; keep replicated
        return P()
    if nd <= 1 or leaf in _REPLICATED or leaf not in _TP_RULES:
        return P()
    m_dim, f_dim = _TP_RULES[leaf]
    if -m_dim > nd:  # e.g. dense "kernel" rule applied to a 2-D tensor
        m_dim = max(m_dim, -nd)
    entries: list[str | None] = [None] * len(shape)
    m_axis = _axis_ok(mesh, MODEL_AXIS, logical[m_dim])
    if m_axis is not None:
        entries[len(shape) + m_dim] = m_axis
    if fsdp and -f_dim <= nd and f_dim != m_dim:
        f_axis = _axis_ok(mesh, "data", logical[f_dim])
        if f_axis is not None and entries[len(shape) + f_dim] is None:
            entries[len(shape) + f_dim] = f_axis
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def param_specs(params, *, fsdp: bool, mesh) -> dict:
    """Spec tree mirroring a ``transformer.init_params`` tree (meta-device
    leaves will do: only shapes are read)."""
    return _map_named(
        lambda names, leaf: _spec_for_leaf(names, tuple(leaf.shape), mesh, fsdp=fsdp), params)


def spec_axes(spec: P) -> frozenset:
    """The mesh axes a spec cuts its tensor over."""
    out = set()
    for e in spec:
        if isinstance(e, tuple):
            out.update(e)
        elif e is not None:
            out.add(e)
    return frozenset(out)


def fsdp_dims(params, mesh) -> dict:
    """Tree mirroring a params tree: each leaf's dim cut over ``data`` by
    FSDP's specs, counted from the right (it is the same in a stacked leaf
    and in one layer of it), or None for a leaf FSDP leaves whole over
    ``data`` (1-D, replicated by name, a dim that does not divide)."""
    def dim(names, leaf):
        spec = _spec_for_leaf(names, tuple(leaf.shape), mesh, fsdp=True)
        hits = [d for d, e in enumerate(spec) if e == "data"]
        return hits[0] - leaf.dim() if hits else None

    return _map_named(dim, params)


def _coord(mesh, coord=None) -> dict:
    """A rank's coordinate by axis name: ``coord`` (a dict), or this rank's."""
    if coord is not None:
        return dict(coord)
    return dict(zip(mesh_axes(mesh), mesh.get_coordinate(), strict=True))


def owner_flags(specs, mesh, axes, distinct=(), coord=None) -> tuple[bool, ...]:
    """Per leaf of a spec tree (``tree_leaves`` order): whether this rank's
    piece counts in a sum over the mesh ``axes``, so that a piece several
    ranks hold alike counts once. It counts where the rank's coordinate is
    0 on every one of ``axes`` that the leaf is not cut over; ``distinct``
    names axes whose ranks hold different values (clients), which every
    rank counts. ``coord`` (axis name -> index) asks it of another rank."""
    names = mesh_axes(mesh)
    coord = _coord(mesh, coord)
    free = [a for a in axes if a in names and a not in distinct]
    return tuple(all(coord[a] == 0 for a in free if a not in spec_axes(s))
                 for s in tree_leaves(specs))


def boxes(like, specs, mesh, coord=None) -> tuple:
    """Per leaf of ``like`` (whole leaves; meta-device ones will do) and its
    spec tree, in ``tree_leaves`` order: this rank's piece's place in the
    whole leaf, a ``utils.flat.Box`` (the whole shape and the piece's first
    index on each dim), as ``local_tree`` cuts it. A dim cut over several
    axes takes them in the entry's order, the first outermost. ``coord``
    (axis name -> index) asks it of another rank."""
    coord = _coord(mesh, coord)
    out = []
    for x, spec in zip(tree_leaves(like), tree_leaves(specs), strict=True):
        start = []
        for d, n in enumerate(x.shape):
            entry = spec[d] if d < len(spec) else None
            index, count = 0, 1
            for a in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
                index, count = index * axis_size(mesh, a) + coord[a], count * axis_size(mesh, a)
            start.append(index * (n // count))
        out.append(Box(tuple(x.shape), tuple(start)))
    return tuple(out)


def group_coords(mesh, axes) -> list[dict]:
    """The coordinates of the ranks of this rank's group over the mesh's
    ``axes`` of size over 1 (``dist.step.mesh_group``'s group), in the
    group's rank order: row-major over those axes in the mesh's order, the
    other axes at this rank's coordinate."""
    names = [a for a in mesh_axes(mesh) if a in axes and axis_size(mesh, a) > 1]
    base = _coord(mesh)
    out = [base]
    for a in names:
        out = [dict(c, **{a: i}) for c in out for i in range(axis_size(mesh, a))]
    return out


def places(like, specs, mesh, axes, *, owners: bool = False) -> tuple:
    """How every rank of the group over ``axes`` (``group_coords``) holds
    its pieces of ``like``'s leaves cut by ``specs``: one ``(owners,
    boxes)`` per rank in the group's rank order, ``owners`` its
    ``owner_flags`` over ``axes`` (None unless asked for) and ``boxes`` its
    ``boxes``: what ``utils.flat.FlatLayout.over`` takes, from the specs
    alone (no collective)."""
    return tuple((owner_flags(specs, mesh, axes, coord=c) if owners else None,
                  boxes(like, specs, mesh, coord=c))
                 for c in group_coords(mesh, axes))


def strip_axes(spec: P, axes) -> P:
    """Drop the named mesh axes from a spec (for stacking per-shard state
    whose leading axis already occupies them)."""
    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            kept = tuple(a for a in entry if a not in axes)
            return kept if kept else None
        return None if entry in axes else entry
    return P(*(keep(e) for e in spec))


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------


def train_batch_specs(cfg, mesh) -> dict:
    """Specs for every train/prefill batch key of ``cfg``'s family: the
    leading global-batch dim is laid over all data-parallel axes, everything
    else replicated."""
    dp = dp_axes(mesh)

    def with_trailing(n):
        return P(dp or None, *([None] * n))

    if cfg.family == "audio":
        # tokens/labels: (B, K, T)
        return {"tokens": with_trailing(2), "labels": with_trailing(2)}
    if cfg.family == "vlm":
        return {
            "tokens": with_trailing(1),
            "labels": with_trailing(1),
            "patch_embeds": with_trailing(2),
        }
    return {"tokens": with_trailing(1), "labels": with_trailing(1)}


def decode_batch_specs(cfg, mesh, global_batch: int | None = None) -> dict:
    """Specs for one decode step's token batch ((B,) or (B, K) for audio)."""
    dp = dp_axes(mesh)
    if global_batch is not None:
        dp = _dp_ok(mesh, dp, global_batch)
    if cfg.family == "audio":
        return {"tokens": P(dp or None, None)}
    return {"tokens": P(dp or None)}


def kv_entry_spec(cfg, mesh) -> P:
    """Spec for one (B, L, KV, D) KV-cache entry: batch over data axes,
    kv heads over model when they divide."""
    dp = dp_axes(mesh)
    kv_axis = _axis_ok(mesh, MODEL_AXIS, max(cfg.num_kv_heads, 1))
    return P(dp or None, None, kv_axis, None)


def kv_page_spec(cfg, mesh) -> P:
    """Spec for one (num_pages, page_size, KV, D) paged-pool entry: kv
    heads over ``model`` when they divide; pages replicated (any slot's
    gather may touch any physical page)."""
    kv_axis = _axis_ok(mesh, MODEL_AXIS, max(cfg.num_kv_heads, 1))
    return P(None, None, kv_axis, None)


def pool_specs(pool, mesh) -> dict:
    """Spec tree mirroring a ``serve.cache.init_pool`` tree: ``k``/``v``
    pages shard kv heads (dim -2) over ``model``, their per-(page slot, kv
    head) scales shard dim -1 to match."""
    def spec(names, leaf):
        name = names[-1]
        nd = leaf.dim()
        entries: list = [None] * nd
        if name in ("k", "v"):
            entries[nd - 2] = _axis_ok(mesh, MODEL_AXIS, leaf.shape[nd - 2])
        elif name in ("k_scale", "v_scale"):
            entries[nd - 1] = _axis_ok(mesh, MODEL_AXIS, leaf.shape[nd - 1])
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    return _map_named(spec, pool)


def cache_specs_from(cache, mesh) -> dict:
    """Spec tree mirroring a ``transformer.init_cache`` tree.

    Leaves are identified by name: ``k``/``v`` ring-cache entries shard
    batch (dim -4) over the data axes and kv heads (dim -2) over ``model``;
    recurrent ``state``/``conv`` entries shard only their batch dim (0, or
    1 under the scanned-group stack).
    """
    dp = dp_axes(mesh)

    def spec(names, leaf):
        leaf_name = names[-1] if names else ""
        stacked = 1 if "groups" in names else 0
        nd = leaf.dim()
        entries: list = [None] * nd
        if leaf_name in ("k", "v") and nd >= 4:
            entries[nd - 4] = _dp_ok(mesh, dp, leaf.shape[nd - 4])
            entries[nd - 2] = _axis_ok(mesh, MODEL_AXIS, leaf.shape[nd - 2])
        elif nd > stacked and dp:
            entries[stacked] = _dp_ok(mesh, dp, leaf.shape[stacked])
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    return _map_named(spec, cache)


# ---------------------------------------------------------------------------
# Shardings and local pieces
# ---------------------------------------------------------------------------


class NamedSharding(NamedTuple):
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor
        dim ``d``'s entry names the mesh dim, ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in mesh_axes(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def named_shardings(mesh, specs):
    """Wrap a spec tree in ``NamedSharding``s."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def local_tree(tree, shardings):
    """Each leaf's local piece on this rank, cut from the whole leaf (which
    every rank holds) as its sharding says; no collective."""
    from torch.distributed.tensor import distribute_tensor

    return tree_map(lambda x, s: distribute_tensor(x, s.mesh, s.placements,
                                                   src_data_rank=None).to_local(),
                    tree, shardings)


def full_tree(tree, shardings):
    """The whole leaves gathered back from every rank's local pieces (a
    collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda x, s: DTensor.from_local(x, s.mesh, s.placements,
                                                    run_check=False).full_tensor(),
                    tree, shardings)
