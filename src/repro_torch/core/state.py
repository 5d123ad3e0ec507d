"""Compression state pytrees (error feedback + momenta).

Fields (paper Algorithm 1):
  u — momentum-correction accumulator   U_{k,t}
  v — error-feedback (memory) residual  V_{k,t}
  m — client-side global momentum       M_{k,t}  (built from broadcasts)

Schemes that don't use a field keep it as an empty dict, as in the JAX
package, so the state structure is the same for every scheme.

Each field is flat (``utils/flat.py``): one ``[N]`` tensor for one
client, the params tree's leaves one after the other in ``tree_leaves``
order, in the leaves' dtype (float32 for an all-float32 tree); a tree of
mixed dtypes has one such tensor per dtype group, as a tuple. The round
engine holds the states of ALL clients as one client-major ``[K, N]``
stack per group, so each (client, leaf) segment is contiguous, and the
sampled clients' rows move in one op per field and group.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils import tree_map
from repro_torch.utils.flat import FlatLayout


class ClientState(NamedTuple):
    u: Any
    v: Any
    m: Any


class ServerState(NamedTuple):
    momentum: Any        # server-side global momentum, flat [N] (DGCwGM only)
    residual: Any        # downlink error-feedback accumulator, flat [N] (downlink=topk only)


def _flat_zeros(params):
    """Zeros of the params' flat layout in the leaves' dtypes, on their
    device (a tuple of one stack per dtype group for a mixed tree)."""
    return FlatLayout.of(params).zeros()


def init_client_state(params, *, use_u: bool, use_v: bool, use_m: bool) -> ClientState:
    zeros = lambda flag: _flat_zeros(params) if flag else {}
    return ClientState(u=zeros(use_u), v=zeros(use_v), m=zeros(use_m))


def init_server_state(params, *, use_momentum: bool,
                      use_residual: bool = False) -> ServerState:
    zeros = lambda flag: _flat_zeros(params) if flag else {}
    return ServerState(momentum=zeros(use_momentum), residual=zeros(use_residual))


def stack_client_states(state: ClientState, num_clients: int) -> ClientState:
    """One client's ``[N]`` state copied to a ``[K, N]`` stack over all clients.

    The JAX reference is a ``broadcast_to``; here that would be an expanded
    view whose rows share storage, and the in-place scatter below would
    write every client at once. The stack is materialised instead."""
    return tree_map(
        lambda x: x.unsqueeze(0).expand((num_clients,) + tuple(x.shape)).contiguous(),
        state)


def gather_client_states(cstates: ClientState, client_idx: torch.Tensor) -> ClientState:
    """Select the sampled clients' rows (``[K, N] -> [k, N]``): one
    ``index_select`` per field."""
    return tree_map(lambda x: x.index_select(0, client_idx), cstates)


def scatter_client_states(cstates: ClientState, client_idx: torch.Tensor,
                          updated: ClientState) -> ClientState:
    """Write the sampled clients' updated rows back into the full stack, one
    ``index_copy_`` per field.

    Unlike the JAX reference (a functional ``.at[].set``) this writes in
    place, so the round holds one copy of the ``[K, ...]`` stack; the
    returned tree is ``cstates`` itself. Rows of another dtype (a bfloat16
    state whose update promoted to float32) are cast to the stack's, as
    the reference's scatter casts them."""
    return tree_map(lambda full, upd: full.index_copy_(0, client_idx, upd.to(full.dtype)),
                    cstates, updated)


# ---------------------------------------------------------------------------
# Topology layouts (fl/engine.py TopologyEngine): both are reorderings of the
# client axis of the flat stacks, chosen so the degenerate cases reduce in the
# star engine's order.
# ---------------------------------------------------------------------------


def group_sum(stack, num_groups: int):
    """Sum a ``[K, W]`` client stack (or a tree of them) within
    ``num_groups`` contiguous groups -> ``[G, W]``. No division: the cloud
    divides by the cohort size once. One group is the star's own call, a
    ``sum(0)`` over the ``[K, W]`` stack, so ``groups=1`` reduces in the
    star's order on either device."""
    if num_groups == 1:
        return tree_map(lambda x: torch.sum(x, dim=0).unsqueeze(0), stack)
    return tree_map(
        lambda x: torch.sum(x.reshape((num_groups, x.shape[0] // num_groups) + x.shape[1:]),
                            dim=1),
        stack)


def interleave_position_stacks(stacks):
    """Merge the ring positions' ``[S, W]`` stacks back into cohort order:
    ``stacks[p]`` holds segment-major rows for position ``p`` (cohort index
    ``j * len(stacks) + p`` for segment ``j``)."""
    k1 = len(stacks)
    if k1 == 1:
        return stacks[0]
    return tree_map(
        lambda *xs: torch.stack(xs, dim=1).reshape((k1 * xs[0].shape[0],) + xs[0].shape[1:]),
        *stacks)
