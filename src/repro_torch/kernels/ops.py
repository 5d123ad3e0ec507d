"""Pytree wrappers for the compression kernels, with the signatures of the
reference's ``kernels/ops.py``.

Each leaf goes by the device it lies on: a CUDA tensor launches the CUDA
kernel (``kernels/gmf_compress.py``) or raises, a CPU tensor takes the
plain version (``kernels/ref.py``). Nothing falls back from the card.
``momentum_correction`` goes by its first leaf and raises unless every
leaf lies on that device: a tree on the card is one multi-tensor K2 launch
(or one per table's capacity of leaves); the flat ``[k, N]`` state is a
tree of one leaf.

``gmf_select``, ``topk_abs_select`` and ``gmf_compress`` take the flat
``[k, N]`` stacks and their ``FlatLayout`` (``utils/flat.py``): one launch
each over all clients and leaves on the card, a loop over the leaves'
views on the CPU. A layout whose segments are cut over a model group
(``FlatLayout.over``) takes ``gmf_select``'s group mode on the card (its
phases as launches, the cut segments' norm sums and histograms all-reduced
over the group between them) and, on the CPU, the plain version's
all-gather of the cut segments' scores.
"""

from __future__ import annotations

import torch

from repro_torch.core import sparsify
from repro_torch.kernels import gmf_compress as _k
from repro_torch.kernels import ref
from repro_torch.utils import tree_leaves, tree_multimap, tree_unflatten


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no compression kernel for tensors on {x.device}")


def _mask_leaf(u, v, mask, state_dtype):
    if state_dtype:  # the Pallas kernel: the mask in v's dtype, outputs in v's
        mask = mask.to(v.dtype)
    if _on_card(u):
        return _k.apply_mask_flat(u, v, mask)
    return ref.apply_mask_update_leaf(u, v, mask)


def momentum_correction(u_tree, v_tree, g_tree, alpha, *, state_dtype=False):
    """K2 over a tree. The outputs are of jnp's promotion of the state's
    dtype and g's, or of the state's under ``state_dtype`` (the Pallas
    kernel's semantics, which the reference takes under ``use_kernels``)."""
    us = tree_leaves(u_tree)
    if not us:
        return ref.momentum_correction(u_tree, v_tree, g_tree, float(alpha), state_dtype)
    vs, gs = tree_leaves(v_tree), tree_leaves(g_tree)
    if not _on_card(us[0]):
        # the whole tree goes by its first leaf: every other leaf must lie
        # on the CPU too, or a leaf on the card would take the plain version
        for x in (*us, *vs, *gs):
            if x.device.type != "cpu":
                raise ValueError(f"momentum_correction: a tree on the cpu holds a leaf "
                                 f"on {x.device}")
        return ref.momentum_correction(u_tree, v_tree, g_tree, float(alpha), state_dtype)
    gs = [g if g.is_contiguous() else g.contiguous() for g in gs]
    s_dtype = us[0].dtype
    # out_dtype only where the state's dtype is not jnp's promotion already
    kw = ({"out_dtype": s_dtype}
          if state_dtype and s_dtype != torch.promote_types(s_dtype, gs[0].dtype) else {})
    uo, vo = _k.momentum_correction_tree(us, vs, gs, float(alpha), **kw)
    return tree_unflatten(u_tree, uo), tree_unflatten(u_tree, vo)


def apply_mask_update(u_tree, v_tree, mask_tree, *, state_dtype=False):
    """K3 over a tree, in jnp's promotion of the state's dtype and the
    mask's, or in the state's under ``state_dtype`` (the Pallas kernel's)."""
    return tree_multimap(lambda u, v, mk: _mask_leaf(u, v, mk, state_dtype), 3,
                         u_tree, v_tree, mask_tree)


def gmf_select(v, m, layout, rate=None, *, keep=None, w, tau, eps):
    """Per (client, leaf) segment: inverse norms and the exact top-k
    threshold of the fusion score -> (inv_nv, inv_nm, thr), ``[k, L]`` each;
    ``w`` and ``tau`` are ``[k]`` float32 on v's device. The keep counts
    come from ``rate`` (shared by every client) or from ``keep``, a per-row
    int64 ``[k, L]`` table (adaptive rates)."""
    table = _keep(layout, rate, keep)
    if _on_card(v):
        return _k.gmf_select_flat(v, m, offsets=layout.offsets_dev, plan=_plan(layout),
                                  keep=table, w=w, tau=tau, eps=eps, group=layout.group)
    return ref.gmf_select(v, m, layout, rate, keep=keep, w=w, tau=tau, eps=eps)


def topk_abs_select(z, layout, rate=None, *, keep=None):
    """The exact top-k threshold of every segment's ``|z|`` and the mask
    -> (thr ``[k, L]``, mask ``[k, N]``); the keep counts as for
    ``gmf_select``."""
    table = _keep(layout, rate, keep)
    if _on_card(z):
        return _k.topk_abs_select_flat(z, offsets=layout.offsets_dev, plan=_plan(layout),
                                       keep=table, group=layout.group)
    if keep is None:
        return sparsify.segment_topk_mask(z, layout, rate)
    return sparsify.segment_topk_mask_keep(z, layout, keep)


def _plan(layout):
    """The select plan of ``layout``: the group mode's where a segment is
    cut over a model group."""
    return layout.select_plan(group=layout.cut)


def _keep(layout, rate, keep):
    """The keep counts the kernel reads: the layout's ``[L]`` at ``rate`` or
    the per-row table ``keep``."""
    if (rate is None) == (keep is None):
        raise ValueError("pass exactly one of rate and keep")
    return layout.keep(rate)[1] if keep is None else keep


def gmf_compress(u, v, m, *, layout, inv_norm_v, inv_norm_m, tau, threshold):
    """The fused GMF mask pass over flat ``[k, N]`` stacks; the scalars are
    ``[k, L]`` float32 (τ ``[k]``) on the stacks' device."""
    kw = dict(inv_norm_v=inv_norm_v, inv_norm_m=inv_norm_m, tau=tau, threshold=threshold)
    if _on_card(v):
        return _k.gmf_compress_flat(u, v, m, offsets=layout.offsets_dev, **kw)
    return ref.gmf_compress_segments(u, v, m, layout=layout, **kw)
