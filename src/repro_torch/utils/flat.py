"""The flat layout of a params tree: every leaf as one segment of a row.

The compression state, the gradients, the payloads and the broadcast are
kept flat: a tree of leaves becomes one ``[..., N]`` tensor whose last
axis holds the leaves one after the other in ``tree_leaves`` order (the
JAX package's order), ``N = sum(n_i)`` exactly, with no padding. Leaf i
takes columns ``[o_i, o_i + n_i)``, so in a client-major ``[k, N]`` stack
each (client, leaf) segment is contiguous. The per-segment steps (norms,
top-k thresholds) and the kernels read the segment offsets; everything
elementwise is one op over the whole stack.

``FlatLayout.of(tree)`` builds a layout once per (structure, device) and
caches it; it holds the offsets on the device and, per compression rate,
the per-leaf keep counts on the host and on the device, each copied once;
and, per block length, the block index of every element for codecs that
work in fixed-length blocks of each leaf (the int8 and probquant wires);
and each column's leaf and index within its leaf (the keyed draws,
``utils/draws.py``); and ``gmf_select``'s plan of the leaves in tiles
(``select_plan``). ``FlatLayout.of_sizes`` is the layout of a list of
1-D leaves, such as the Hadamard rotation's padded leaves.
``flatten`` is one ``torch.cat``; ``unflatten`` makes views, for the edges
(the model's params, tests, evaluation).

The state starts in the leaves' own dtype, as the reference's does
(``tree_zeros_like``): ``zeros`` is of the layout's ``dtype``, so an
all-float32 tree keeps its float32 stacks and a bfloat16 model gets
bfloat16 ones. A tree whose leaves have more than one dtype (a bfloat16
model with float32 routers or gates) has a ``GroupedLayout``: one
``FlatLayout`` per dtype, each over that dtype's leaves in
``tree_leaves`` order, and every flat quantity is a tuple of one stack per
group. ``FlatLayout.of`` returns whichever the tree needs.

Under tensor parallelism, and FSDP, a rank's tree holds its pieces of
leaves cut over a group of ranks (the mesh's model group, or a pod's data
× model ranks): ``layout.over(group, full_sizes, owners)`` is the layout
of those pieces that also knows each segment's whole size (``full_sizes``)
and whether it is cut (``cut_flags``). Its keep counts come from the whole
sizes; a cut segment's norms are summed over the group and its threshold
is that of the whole leaf (``gmf_select``'s group mode on the card, an
all-gather and ``torch.topk`` on the CPU); ``nnz`` counts a cut segment's
entries over the group and a whole one's once. A segment cut over only
some of the group's axes (a leaf FSDP leaves whole, cut over the model
axis alone) is held alike by several ranks of the group (``shared_flags``,
the same on every rank): only one of them owns it (``owner_flags``, this
rank's), and the others' pieces count zero in every sum and are left out
of every gather over the group, so it counts once.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


# One layout per (structure, device), built at first use.
_LAYOUTS: dict = {}


def _signature(tree):
    """A hashable description of ``tree``'s structure, leaf shapes and dtypes."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return ("dict", tuple((k, _signature(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_signature(x) for x in tree))
    raise TypeError(f"a flat layout takes trees of tensors, got a {type(tree).__name__} leaf")


class FlatLayout:
    """Leaf shapes, sizes and offsets of one tree structure on one device."""

    groups = None  # one dtype: the stacks are tensors, not tuples
    group = None   # the model group a segment may be cut over (``over``)

    def __init__(self, tree, device):
        self.device = torch.device(device)
        self.skeleton = tree_map(lambda x: None, tree)
        leaves = tree_leaves(tree)
        self.dtype = leaves[0].dtype if leaves else torch.float32
        self.shapes = tuple(tuple(x.shape) for x in leaves)
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        offsets = [0]
        for n in self.sizes:
            offsets.append(offsets[-1] + n)
        self.offsets = tuple(offsets)  # L + 1 entries, the last is N
        self.total = offsets[-1]
        self.num_leaves = len(self.sizes)
        self.offsets_dev = torch.tensor(offsets, dtype=torch.int64, device=self.device)
        self.sizes_dev = torch.tensor(self.sizes, dtype=torch.int64, device=self.device)
        self._keep: dict[float, tuple[tuple[int, ...], torch.Tensor]] = {}
        self._blocks: dict[int, tuple[int, torch.Tensor]] = {}
        self._positions: tuple[torch.Tensor, torch.Tensor] | None = None
        self._select = None
        self._select_group = None
        self.full_sizes = self.sizes
        self.full_total = self.total
        self.cut_flags = (False,) * self.num_leaves
        self.owner_flags = (True,) * self.num_leaves
        self.shared_flags = (False,) * self.num_leaves
        self._owner_mask = None
        self._over: dict = {}

    def over(self, group, full_sizes, owners=None) -> FlatLayout:
        """This layout as the rank's pieces of leaves whose whole sizes are
        ``full_sizes``, a segment cut over ``group`` where its size differs
        (made once per group, sizes and owners). ``owners`` (a bool a leaf,
        default all) says which cut segments this rank's piece counts for:
        False where another rank of the group holds the same piece (a
        segment some rank does not own is ``shared``: the ranks agree on
        that in one all-reduce when the layout is made, a collective of the
        group). A group of one, or no segment cut, gives this layout
        itself."""
        full_sizes = tuple(int(n) for n in full_sizes)
        if len(full_sizes) != self.num_leaves:
            raise ValueError(f"{len(full_sizes)} whole sizes for {self.num_leaves} leaves")
        cut = tuple(f != n for f, n in zip(full_sizes, self.sizes, strict=True))
        if group is None or dist.get_world_size(group) == 1 or not any(cut):
            return self
        owners = (True,) * self.num_leaves if owners is None else tuple(bool(o) for o in owners)
        if len(owners) != self.num_leaves:
            raise ValueError(f"{len(owners)} owner flags for {self.num_leaves} leaves")
        key = (group, full_sizes, owners)  # the group itself: its id is not reused while held
        if key not in self._over:
            out = copy.copy(self)
            out.group, out.full_sizes, out.cut_flags = group, full_sizes, cut
            out.owner_flags = tuple(o or not c for o, c in zip(owners, cut, strict=True))
            others = torch.tensor([int(not o) for o in out.owner_flags], dtype=torch.int64,
                                  device=self.device)
            dist.all_reduce(others, group=group)  # ranks that do not own their piece
            out.shared_flags = tuple(bool(x) for x in others.tolist())
            out.full_total = sum(full_sizes)
            out._keep, out._select_group, out._over, out._owner_mask = {}, None, {}, None
            self._over[key] = out
        return self._over[key]

    @property
    def shared(self) -> bool:
        """Whether some cut segment is held alike by several ranks of the
        group (the same on every rank)."""
        return any(self.shared_flags)

    def owner_mask(self) -> torch.Tensor:
        """The owner flags of the cut segments, in leaf order, as a float32
        device tensor (made once): the factor of their sums over the group."""
        if self._owner_mask is None:
            self._owner_mask = torch.tensor(
                [float(o) for o, c in zip(self.owner_flags, self.cut_flags, strict=True) if c],
                dtype=torch.float32, device=self.device)
        return self._owner_mask

    @property
    def cut(self) -> bool:
        """Whether a segment is cut over a group of more than one rank."""
        return self.group is not None

    def nnz(self, x: torch.Tensor) -> torch.Tensor:
        """Nonzero entries along the last axis of ``x`` ([..., N]) in the
        whole leaves: a cut segment's summed over the group, a replicated
        one's counted once. int64, no host sync."""
        n = torch.count_nonzero(x, dim=-1)
        if not self.cut:
            return n
        segs = self.segments(x)
        whole = [torch.count_nonzero(seg, dim=-1) for seg, cut in
                 zip(segs, self.cut_flags, strict=True) if not cut]
        rep = sum(whole) if whole else torch.zeros_like(n)
        if self.shared:  # the cut segments this rank owns
            own = [torch.count_nonzero(seg, dim=-1) for seg, cut, o in
                   zip(segs, self.cut_flags, self.owner_flags, strict=True) if cut and o]
            part = (sum(own) if own else torch.zeros_like(n)).contiguous()
        else:
            part = (n - rep).contiguous()
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self.group)
        return part + rep

    @staticmethod
    def of(tree) -> FlatLayout | GroupedLayout:
        """The layout of ``tree`` (its leaves' device), built once per
        (structure, dtypes, device): a ``GroupedLayout`` when the leaves
        have more than one dtype."""
        leaves = tree_leaves(tree)
        device = leaves[0].device if leaves else torch.device("cpu")
        key = (_signature(tree), str(device))
        if key not in _LAYOUTS:
            mixed = len({x.dtype for x in leaves}) > 1
            _LAYOUTS[key] = (GroupedLayout if mixed else FlatLayout)(tree, device)
        return _LAYOUTS[key]

    @staticmethod
    def of_sizes(sizes, device) -> FlatLayout:
        """The layout of a list of 1-D leaves of ``sizes`` on ``device``,
        built once per (sizes, device)."""
        key = (("sizes", tuple(sizes)), str(torch.device(device)))
        if key not in _LAYOUTS:
            _LAYOUTS[key] = FlatLayout([torch.empty((n,), device="meta") for n in sizes],
                                       device)
        return _LAYOUTS[key]

    def positions(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Every column's leaf and its index within that leaf: two int64
        ``[N]`` tensors on the device, made once."""
        if self._positions is None:
            leaf = self.expand(torch.arange(self.num_leaves, dtype=torch.int64,
                                            device=self.device))
            pos = torch.arange(self.total, dtype=torch.int64, device=self.device) - self.expand(
                self.offsets_dev[:-1])
            self._positions = leaf, pos
        return self._positions

    def keep(self, rate: float) -> tuple[tuple[int, ...], torch.Tensor]:
        """Per-leaf keep counts ``num_keep(n_i, rate)`` of the whole leaves'
        sizes: on the host and as an int64 ``[L]`` device tensor, each made
        once per rate."""
        from repro_torch.core.sparsify import num_keep

        if rate not in self._keep:
            host = tuple(num_keep(n, rate) for n in self.full_sizes)
            self._keep[rate] = host, torch.tensor(host, dtype=torch.int64, device=self.device)
        return self._keep[rate]

    def blocks(self, block: int) -> tuple[int, torch.Tensor]:
        """Each leaf cut into ``block``-element blocks from its own offset
        (the last one short): (blocks a row, int64 ``[N]`` block index of
        every column), made on the device once per block length. Leaf i's
        blocks are numbered after those of leaves 0..i-1."""
        if block not in self._blocks:
            counts = [-(-n // block) for n in self.sizes]
            starts = [0]
            for c in counts:
                starts.append(starts[-1] + c)
            first = torch.tensor(starts[:-1], dtype=torch.int64, device=self.device)
            self._blocks[block] = starts[-1], self.positions()[1] // block + self.expand(first)
        return self._blocks[block]

    def select_plan(self, group: bool = False):
        """``gmf_select``'s plan of this layout's leaves in tiles of
        ``select_tile(sizes)`` elements, with its table on the device: made
        and copied once (``kernels.gmf_compress.plan_select``). ``group``:
        the group mode's plan, every cut segment among the split ones,
        first."""
        from repro_torch.kernels import gmf_compress as gk

        plan = lambda: gk.plan_select(self.sizes, gk.select_tile(self.sizes))  # noqa: E731
        if group:
            if self._select_group is None:
                self._select_group = gk.select_table(plan(), self.device, group=self.cut_flags,
                                                     owners=self.owner_flags)
            return self._select_group
        if self._select is None:
            self._select = gk.select_table(plan(), self.device)
        return self._select

    def flatten(self, tree) -> torch.Tensor:
        """A tree of ``[*lead, *shape_i]`` leaves -> one ``[*lead, N]`` tensor."""
        leaves = tree_leaves(tree)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"{len(leaves)} leaves for a layout of {self.num_leaves}")
        flat = [x.reshape(*x.shape[:x.dim() - len(s)], -1)
                for x, s in zip(leaves, self.shapes, strict=True)]
        return torch.cat(flat, dim=-1)

    def segments(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Views ``flat[..., o_i:o_i + n_i]``, one per leaf."""
        self._check(flat)
        return [flat[..., o:o + n] for o, n in zip(self.offsets, self.sizes)]

    def unflatten(self, flat: torch.Tensor):
        """``[*lead, N]`` -> a tree of ``[*lead, *shape_i]`` views of ``flat``."""
        lead = tuple(flat.shape[:-1])
        views = [seg.view(*lead, *s) for seg, s in zip(self.segments(flat), self.shapes)]
        return tree_unflatten(self.skeleton, views)

    def expand(self, per_leaf: torch.Tensor) -> torch.Tensor:
        """``[..., L]`` per-leaf values -> ``[..., N]``, each value repeated
        over its leaf's columns (no host sync)."""
        return torch.repeat_interleave(per_leaf, self.sizes_dev.to(per_leaf.device), dim=-1,
                                       output_size=self.total)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.total, dtype=self.dtype, device=self.device)

    def _check(self, flat: torch.Tensor) -> None:
        if flat.shape[-1] != self.total:
            raise ValueError(f"last axis {flat.shape[-1]} != the layout's {self.total}")


class GroupedLayout:
    """The flat layout of a tree of mixed dtypes: one ``FlatLayout`` per
    dtype (``groups``, in the order each dtype first appears among the
    leaves), over that dtype's leaves in ``tree_leaves`` order. Every flat
    quantity is a tuple with one ``[..., N_g]`` stack per group; the
    groups' sizes add up to ``total``."""

    def __init__(self, tree, device):
        self.device = torch.device(device)
        self.skeleton = tree_map(lambda x: None, tree)
        leaves = tree_leaves(tree)
        self.dtypes = tuple(dict.fromkeys(x.dtype for x in leaves))
        self.index = tuple(tuple(i for i, x in enumerate(leaves) if x.dtype == d)
                           for d in self.dtypes)
        self.groups = tuple(FlatLayout([leaves[i] for i in idx], device)
                            for idx in self.index)
        self.shapes = tuple(tuple(x.shape) for x in leaves)
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        self.total = sum(self.sizes)
        self.full_total = self.total
        self.num_leaves = len(leaves)
        self._over: dict = {}

    def over(self, group, full_sizes, owners=None) -> GroupedLayout:
        """``FlatLayout.over`` for each dtype group (``full_sizes`` and
        ``owners`` of every leaf, in ``tree_leaves`` order)."""
        full_sizes = tuple(int(n) for n in full_sizes)
        owners = (True,) * self.num_leaves if owners is None else tuple(bool(o) for o in owners)
        subs = tuple(g.over(group, [full_sizes[i] for i in idx], [owners[i] for i in idx])
                     for g, idx in zip(self.groups, self.index, strict=True))
        if all(a is b for a, b in zip(subs, self.groups, strict=True)):
            return self
        key = (group, full_sizes, owners)
        if key not in self._over:
            out = copy.copy(self)
            out.groups, out.full_total, out._over = subs, sum(full_sizes), {}
            self._over[key] = out
        return self._over[key]

    def flatten(self, tree) -> tuple:
        """A tree of ``[*lead, *shape_i]`` leaves -> one ``[*lead, N_g]``
        stack per group."""
        leaves = tree_leaves(tree)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"{len(leaves)} leaves for a layout of {self.num_leaves}")
        return tuple(g.flatten([leaves[i] for i in idx])
                     for g, idx in zip(self.groups, self.index, strict=True))

    def unflatten(self, flats) -> object:
        """One ``[*lead, N_g]`` stack per group -> a tree of views."""
        leaves = [None] * self.num_leaves
        for g, idx, flat in zip(self.groups, self.index, flats, strict=True):
            for i, view in zip(idx, g.unflatten(flat), strict=True):
                leaves[i] = view
        return tree_unflatten(self.skeleton, leaves)

    def zeros(self) -> tuple:
        return tuple(g.zeros() for g in self.groups)
