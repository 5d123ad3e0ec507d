"""Pytree helpers for nested dicts (and tuples / NamedTuples) of tensors.

Leaves are visited in sorted-key order for dicts, as ``jax.tree_util``
does, so leaf ``i`` of a port tree is leaf ``i`` of the JAX tree with the
same keys. An empty dict is a subtree with no leaves (the convention the
compression states use for fields a scheme does not need).
"""

from __future__ import annotations

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and same-structured ``rest``."""
    if isinstance(tree, torch.Tensor):  # the common leaf, tested first
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``tree_map`` order, without building a tree."""
    out = []
    _collect(tree, out)
    return out


def _collect(tree, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _collect(x, out)
    else:
        out.append(tree)


def tree_unflatten(like, leaves):
    """Rebuild ``leaves`` (in ``tree_leaves`` order) into ``like``'s structure."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(x, it) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return next(it)


def tree_multimap(fn, n_out: int, *trees):
    """``tree_map`` for leaf functions returning ``n_out`` values."""
    outs = [fn(*xs) for xs in zip(*(tree_leaves(t) for t in trees), strict=True)]
    return tuple(tree_unflatten(trees[0], [o[i] for o in outs]) for i in range(n_out))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_size(tree) -> int:
    """Total number of elements across all leaves (Python int)."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_size_scalar(tree) -> torch.Tensor:
    """``tree_size`` as a 0-dim int64 tensor on the leaves' device (the
    reference's device scalar; int64 is exact at any size)."""
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    return torch.full((), tree_size(tree), dtype=torch.int64, device=device)


def tree_bytes(tree) -> int:
    """Total number of bytes across all leaves (Python int)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_nnz(tree, *, client_axis: bool = False) -> torch.Tensor:
    """Exact int64 count of non-zero elements across all leaves.

    ``client_axis=True`` treats dim 0 of every leaf as the client axis and
    returns one count per client (shape ``[k]``). The count stays on the
    leaves' device; reading it is the caller's one host sync."""
    leaves = tree_leaves(tree)
    if client_axis:
        return sum(torch.count_nonzero(x.reshape(x.shape[0], -1), dim=1) for x in leaves)
    return sum(torch.count_nonzero(x) for x in leaves)


def tree_l2_norm(tree) -> torch.Tensor:
    """Global L2 norm over all leaves (float32 device scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


global_norm = tree_l2_norm


def tree_any_nan(tree) -> torch.Tensor:
    """Does any leaf hold a NaN or an infinity? (a 0-dim bool tensor)"""
    bad = torch.zeros((), dtype=torch.bool)
    for x in tree_leaves(tree):
        bad = bad.to(x.device) | ~torch.isfinite(x.float()).all()
    return bad


def flatten_dotted(tree, prefix: str = "") -> dict:
    """Nested dict -> flat ``{"a.b.c": tensor}`` (``nn.Module`` naming)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_dotted(v, name + "."))
        else:
            out[name] = v
    return out
