"""Parameter conversion between the JAX reference's trees and the port's.

Trees arrive and leave as numpy arrays, so this module needs neither
framework's arrays on the other side. Dicts, tuples and lists are walked
and keep their types, so the transformer's tree (a tuple of stacked layer
dicts, a tuple tail) carries across leaf for leaf.

``layout`` names the tree's model, and with it the leaves whose layout
differs between the packages:

  * ``"resnet"`` (the default): JAX convolutions keep HWIO kernels, the
    port runs OIHW, so the 4-D leaves are transposed; every other leaf
    keeps its layout (the head's ``kernel`` is ``(in, out)`` in both);
  * ``"transformer"``: every leaf keeps its layout (dense kernels are
    ``(d_in, d_out)`` in both packages, and 4-D leaves such as stacked
    expert weights are not convolutions);
  * ``"lstm"``: every leaf keeps its layout (``x @ wx`` and ``h @ wh``
    read the same in both packages).

bfloat16 crosses bit for bit: numpy holds it as ``ml_dtypes.bfloat16``,
which torch does not read, so the 16 bits go through an int16 view.
Converting bfloat16 back to numpy needs that type registered, as it is in
any process that has imported JAX.
"""

from __future__ import annotations

import numpy as np
import torch

LAYOUTS = ("resnet", "transformer", "lstm")


def _check(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")


def _to_torch(x, device, layout):
    a = np.asarray(x)
    if layout == "resnet" and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, order="C").view(np.int16))  # a copy
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _to_numpy(t, layout):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        a = t.contiguous().view(torch.int16).numpy().view(np.dtype("bfloat16"))
    else:
        a = t.numpy()
    if layout == "resnet" and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return np.ascontiguousarray(a)


def from_jax_params(np_tree, device="cpu", layout: str = "resnet"):
    """A tree of numpy arrays in JAX layout -> port params on ``device``."""
    _check(layout)
    if isinstance(np_tree, dict):
        return {k: from_jax_params(v, device, layout) for k, v in np_tree.items()}
    if isinstance(np_tree, (tuple, list)):
        return type(np_tree)(from_jax_params(v, device, layout) for v in np_tree)
    return _to_torch(np_tree, device, layout)


def to_jax_params(tree, layout: str = "resnet"):
    """Port params -> a tree of numpy arrays in JAX layout."""
    _check(layout)
    if isinstance(tree, dict):
        return {k: to_jax_params(v, layout) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_jax_params(v, layout) for v in tree)
    return _to_numpy(tree, layout)
