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
group. ``FlatLayout.of`` returns whichever the tree needs. Each group's
layout knows its leaves' places in the whole tree: ``leaf_ids`` (their
numbers, which key the draws) and ``tree_sizes`` (every leaf's size, so
that ``tree_index`` is the index in the whole tree's flat order), and so
does each group's layout cut over a group of ranks
(``GroupedLayout.over``); ``where`` gives every leaf's (group, place).

Under tensor parallelism, and FSDP, a rank's tree holds its pieces of
leaves cut over a group of ranks (the mesh's model group, or a pod's data
× model ranks): ``layout.over(group, full_sizes, places)`` is the layout
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
of every gather over the group, so it counts once. ``places`` holds every
rank's owner flags (and boxes, below), which the specs and the mesh give
on the host (``dist.sharding.places``): making a layout is no collective.

The stages that cut or key a leaf by its flat coordinate (the sampled
estimator, global top-k, random-k, the sketch, the int8 and probquant
wires, the Hadamard rotation) need to know where a piece lies in its
whole leaf: ``over(..., places)`` takes each rank's pieces' ``Box`` (the
whole leaf's shape and the piece's first index on each dim,
``dist.sharding.boxes``), and the layout then gives whole coordinates:
``whole_index(i)`` (each entry's index within its whole leaf, made per
segment so that no ``[N]`` index tensor need be held), ``positions``,
``blocks`` (blocks of the whole leaves, numbered over the whole leaves)
and ``tree_index(i)`` (the index in the whole tree's flat order).
``counted`` says which segments count on this rank in a sum over the
group (a cut piece its owner's, a whole leaf the group's first rank's);
``whole_leaf`` / ``piece`` gather a cut segment whole in its flat order
and cut the rank's piece back out.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


# One layout per (structure, device), built at first use.
_LAYOUTS: dict = {}


# The columns a count of nonzeros takes at once: torch's count_nonzero holds a
# bool and an int64 copy of what it counts (9 bytes an element, 13.5 GB over
# llama3.2-1b's row), so a longer row is counted a slice at a time.
COUNT_SLICE = 1 << 26


def count_nonzero(x: torch.Tensor) -> torch.Tensor:
    """Nonzero entries along the last axis of ``x``, int64 ``[...]``, counted
    in slices of at most ``COUNT_SLICE`` columns (no host sync)."""
    if x.shape[-1] <= COUNT_SLICE:
        return torch.count_nonzero(x, dim=-1)
    return sum(torch.count_nonzero(part, dim=-1) for part in x.split(COUNT_SLICE, dim=-1))


class Box(NamedTuple):
    """A piece's place in its whole leaf: the whole leaf's shape and the
    piece's first index on each dim (the piece's own shape gives its
    extent)."""

    shape: tuple[int, ...]
    start: tuple[int, ...]


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
        self.full_sizes_dev = self.sizes_dev
        self.full_total = self.total
        self.cut_flags = (False,) * self.num_leaves
        self.owner_flags = (True,) * self.num_leaves
        self.shared_flags = (False,) * self.num_leaves
        self.boxes = None
        self.places = None  # every rank of the group's (owners, boxes), ``over``
        # each leaf's number in the whole tree (the draws' keys), and the whole
        # tree's leaf sizes where this layout holds one dtype group of it
        # (``GroupedLayout``; None: the layout's own ``full_sizes``)
        self.leaf_ids = tuple(range(self.num_leaves))
        self.tree_sizes = None
        self._owner_mask = None
        self._over: dict = {}

    def over(self, group, full_sizes, places=None, tree_sizes=None) -> FlatLayout:
        """This layout as the rank's pieces of leaves whose whole sizes are
        ``full_sizes``, a segment cut over ``group`` where its size differs
        (made once per group, sizes and places). ``places`` says how every
        rank of the group holds its pieces: one ``(owners, boxes)`` per rank,
        in the group's rank order (``dist.sharding.places``; None: every
        rank owns its pieces, and none is placed). ``owners`` (a bool a leaf,
        or None for all) says which cut segments a rank's piece counts for:
        False where another rank of the group holds the same piece (a
        segment some rank does not own is ``shared``). ``boxes`` (a ``Box``
        a leaf, or None) place a rank's pieces in their whole leaves, for the
        stages that cut or key a leaf by flat coordinate. All of it is known
        on the host, so making the layout issues no collective. A group of
        one, or no segment cut, gives this layout itself. ``tree_sizes``:
        the whole tree's leaf sizes where this layout is one dtype group of
        it (``GroupedLayout.over``)."""
        full_sizes = tuple(int(n) for n in full_sizes)
        if len(full_sizes) != self.num_leaves:
            raise ValueError(f"{len(full_sizes)} whole sizes for {self.num_leaves} leaves")
        cut = tuple(f != n for f, n in zip(full_sizes, self.sizes, strict=True))
        tree_sizes = None if tree_sizes is None else tuple(int(n) for n in tree_sizes)
        if group is None or dist.get_world_size(group) == 1 or not any(cut):
            if tree_sizes is None or tree_sizes == self.tree_sizes:
                return self
            # a group none of whose leaves is cut, in a tree whose others are
            if tree_sizes not in self._over:
                out = copy.copy(self)
                out.tree_sizes, out._over = tree_sizes, {}
                self._over[tree_sizes] = out
            return self._over[tree_sizes]
        size = dist.get_world_size(group)
        places = ((None, None),) * size if places is None else tuple(places)
        if len(places) != size:
            raise ValueError(f"{len(places)} places for a group of {size} ranks")
        norm = []
        for owners, boxes in places:
            owners = (True,) * self.num_leaves if owners is None else tuple(bool(o)
                                                                           for o in owners)
            if len(owners) != self.num_leaves:
                raise ValueError(f"{len(owners)} owner flags for {self.num_leaves} leaves")
            if boxes is not None:
                boxes = tuple(Box(tuple(b.shape), tuple(b.start)) for b in boxes)
                self._check_boxes(boxes, full_sizes)
            norm.append((tuple(o or not c for o, c in zip(owners, cut, strict=True)), boxes))
        places = tuple(norm)
        # the group itself: its id is not reused while held
        key = (group, full_sizes, places, tree_sizes)
        if key not in self._over:
            out = copy.copy(self)
            out.group, out.full_sizes, out.cut_flags, out.places = group, full_sizes, cut, places
            if tree_sizes is not None:
                out.tree_sizes = tree_sizes
            out.owner_flags, out.boxes = places[dist.get_rank(group)]
            # a segment some rank of the group does not own
            out.shared_flags = tuple(not all(p[0][i] for p in places)
                                     for i in range(self.num_leaves))
            out.full_total = sum(full_sizes)
            out.full_sizes_dev = torch.tensor(full_sizes, dtype=torch.int64, device=self.device)
            out._keep, out._select_group, out._over, out._owner_mask = {}, None, {}, None
            out._blocks, out._positions = {}, None
            self._over[key] = out
        return self._over[key]

    def _check_boxes(self, boxes, full_sizes) -> None:
        if len(boxes) != self.num_leaves:
            raise ValueError(f"{len(boxes)} boxes for {self.num_leaves} leaves")
        for i, (box, full, shape) in enumerate(zip(boxes, full_sizes, self.shapes, strict=True)):
            if (math.prod(box.shape) != full or len(box.shape) != len(shape)
                    or len(box.start) != len(shape)
                    or any(a < 0 or a + e > n for a, e, n in zip(box.start, shape, box.shape))):
                raise ValueError(f"leaf {i}: a piece of shape {shape} does not lie in {box}")

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
        n = count_nonzero(x)
        if not self.cut:
            return n
        segs = self.segments(x)
        whole = [count_nonzero(seg) for seg, cut in
                 zip(segs, self.cut_flags, strict=True) if not cut]
        rep = sum(whole) if whole else torch.zeros_like(n)
        if self.shared:  # the cut segments this rank owns
            own = [count_nonzero(seg) for seg, cut, o in
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
        """Every column's leaf and its index within that leaf (the whole
        leaf, on a cut layout): two int64 ``[N]`` tensors on the device,
        made once."""
        if self._positions is None:
            leaf = self.expand(torch.arange(self.num_leaves, dtype=torch.int64,
                                            device=self.device))
            if self.cut:
                pos = torch.cat([self.whole_index(i) for i in range(self.num_leaves)])
            else:
                pos = torch.arange(self.total, dtype=torch.int64,
                                   device=self.device) - self.expand(self.offsets_dev[:-1])
            self._positions = leaf, pos
        return self._positions

    def whole_index(self, i: int) -> torch.Tensor:
        """Each entry of segment ``i``'s index within its whole leaf, int64
        ``[n_i]`` on the device (made anew: no ``[N]`` tensor is held)."""
        if self.boxes is None:
            if self.cut_flags[i]:
                raise ValueError("the whole-leaf coordinates of a cut segment need the pieces' "
                                 "boxes: FlatLayout.over(..., places=...)")
            return torch.arange(self.sizes[i], dtype=torch.int64, device=self.device)
        box, shape = self.boxes[i], self.shapes[i]
        nd = len(shape)
        idx = torch.zeros((), dtype=torch.int64, device=self.device)
        stride = 1
        for d in reversed(range(nd)):
            ar = torch.arange(box.start[d], box.start[d] + shape[d], dtype=torch.int64,
                              device=self.device) * stride
            idx = idx + ar.view([1] * d + [shape[d]] + [1] * (nd - 1 - d))
            stride *= box.shape[d]
        return idx.reshape(-1)

    def tree_index(self, i: int) -> torch.Tensor:
        """Each entry of segment ``i``'s index in the whole tree's flat order
        (the whole leaves one after the other, every dtype group's where
        this layout holds one group of a tree), int64 ``[n_i]``."""
        sizes = self.full_sizes if self.tree_sizes is None else self.tree_sizes
        return self.whole_index(i) + sum(sizes[:self.leaf_ids[i]])

    @property
    def counted(self) -> tuple[bool, ...]:
        """Per leaf, whether this rank's segment counts in a sum over the
        group: a cut piece where the rank owns it, a whole leaf (held alike
        by every rank of the group) on the group's first rank alone."""
        if not self.cut:
            return (True,) * self.num_leaves
        first = dist.get_rank(self.group) == 0
        return tuple(o if c else first
                     for c, o in zip(self.cut_flags, self.owner_flags, strict=True))

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
        blocks are numbered after those of leaves 0..i-1. On a cut layout
        these are the whole leaves' blocks, a block of a cut leaf possibly
        straddling ranks (``cut_blocks``)."""
        if block not in self._blocks:
            counts = [-(-n // block) for n in self.full_sizes]
            starts = [0]
            for c in counts:
                starts.append(starts[-1] + c)
            # segment by segment: no [N] positions are held for it
            idx = torch.cat([self.whole_index(i) // block + starts[i]
                             for i in range(self.num_leaves)])
            cut = None
            if self.cut:
                cut = torch.cat([torch.arange(starts[i], starts[i + 1], dtype=torch.int64)
                                 for i, c in enumerate(self.cut_flags) if c]).to(self.device)
            self._blocks[block] = starts[-1], idx, cut
        return self._blocks[block][:2]

    def cut_blocks(self, block: int) -> torch.Tensor:
        """The block numbers (``blocks``) of the cut leaves, int64 on the
        device: the blocks whose entries several ranks hold."""
        self.blocks(block)
        return self._blocks[block][2]

    def whole_leaf(self, seg: torch.Tensor, i: int) -> torch.Tensor:
        """Segment ``i`` of a ``[k, n_i]`` stack as its whole leaf, ``[k,
        full_i]`` in the leaf's flat order: the owners' pieces gathered over
        the group and put in their boxes where the segment is cut (a
        collective of the group), else the segment itself."""
        if not self.cut_flags[i]:
            return seg
        if any(b is None for _, b in self.places):
            raise ValueError("gathering a cut leaf whole needs every rank's boxes: "
                             "FlatLayout.over(..., places=...)")
        k, shape = seg.shape[0], self.shapes[i]
        parts = [torch.empty_like(seg, memory_format=torch.contiguous_format)
                 for _ in self.places]
        dist.all_gather(parts, seg.contiguous(), group=self.group)
        whole = seg.new_empty((k, *self.boxes[i].shape))
        for part, (owners, boxes) in zip(parts, self.places, strict=True):
            if owners[i]:
                at = tuple(slice(a, a + e) for a, e in zip(boxes[i].start, shape))
                whole[(slice(None),) + at] = part.view(k, *shape)
        return whole.reshape(k, -1)

    def piece(self, whole: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's piece ``[k, n_i]`` of leaf ``i``'s whole ``[k, full_i]``
        (the inverse of ``whole_leaf``)."""
        if not self.cut_flags[i]:
            return whole
        box, shape = self.boxes[i], self.shapes[i]
        at = tuple(slice(a, a + e) for a, e in zip(box.start, shape))
        return whole.reshape(whole.shape[0], *box.shape)[(slice(None),) + at].reshape(
            whole.shape[0], -1)

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
                                                     owners=self.owner_flags,
                                                     whole=self.full_sizes)
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
        self.shapes = tuple(tuple(x.shape) for x in leaves)
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        groups = []
        for idx in self.index:  # each group keyed and indexed by its leaves' tree places
            g = FlatLayout([leaves[i] for i in idx], device)
            g.leaf_ids, g.tree_sizes = idx, self.sizes
            groups.append(g)
        self.groups = tuple(groups)
        # every leaf's (group, place in its group), in tree_leaves order
        place = {i: (g, p) for g, idx in enumerate(self.index) for p, i in enumerate(idx)}
        self.where = tuple(place[i] for i in range(len(leaves)))
        self.total = sum(self.sizes)
        self.full_total = self.total
        self.num_leaves = len(leaves)
        self._over: dict = {}

    @property
    def cut(self) -> bool:
        """Whether a group's segment is cut over a group of ranks."""
        return any(g.cut for g in self.groups)

    @property
    def group(self):
        """The process group the cut segments lie over (None if none is cut)."""
        return next((g.group for g in self.groups if g.cut), None)

    def over(self, group, full_sizes, places=None) -> GroupedLayout:
        """``FlatLayout.over`` for each dtype group (``full_sizes`` and each
        rank's owners and boxes of every leaf, in ``tree_leaves`` order);
        each group's cut layout keeps its leaves' tree places."""
        full_sizes = tuple(int(n) for n in full_sizes)
        places = None if places is None else tuple(
            (None if o is None else tuple(o), None if b is None else tuple(b)) for o, b in places)

        def sub(idx):
            return None if places is None else tuple(
                (None if o is None else [o[i] for i in idx],
                 None if b is None else [b[i] for i in idx]) for o, b in places)

        subs = tuple(g.over(group, [full_sizes[i] for i in idx], sub(idx), tree_sizes=full_sizes)
                     for g, idx in zip(self.groups, self.index, strict=True))
        if all(a is b for a, b in zip(subs, self.groups, strict=True)):
            return self
        key = (group, full_sizes, places)
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
