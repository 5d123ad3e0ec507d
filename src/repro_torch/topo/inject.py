"""Where an incoming ring payload enters the next client's compression, so
that every hop re-applies the scheme's selector and wire against the
receiving client's own state:

* error-feedback schemes (``uses_v``): into the EF residual ``V`` before the
  compensator accumulates, so the incoming sum competes in this client's
  top-k (and falls back into its residual when dropped) without entering
  the momentum-correction accumulator ``U``, which models local history;
* stateless mask schemes: into the local gradient before selection;
* sketch schemes (FetchSGD): count sketches are linear, so the sum is added
  after compression (``add_after``).
"""

from __future__ import annotations

import torch

from repro_torch.utils import tree_map


def inject_incoming(scheme, states, grads, incoming):
    """Thread ``incoming`` (the predecessor's accumulated ``[S, W]`` payload
    stack, or None at the first position) into one hop's flat ``[S, N]``
    states and gradients (one stack per dtype group of a tree of mixed
    dtypes, each added to its own). Returns ``(states, grads, add_after)``; with
    ``add_after`` the caller adds ``incoming`` to the compressed payload."""
    if incoming is None:
        return states, grads, False
    if scheme.is_sketch:
        return states, grads, True
    if scheme.uses_v:
        return states._replace(v=tree_map(torch.add, states.v, incoming)), grads, False
    return states, tree_map(torch.add, grads, incoming), False
