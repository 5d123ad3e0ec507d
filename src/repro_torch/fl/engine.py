"""The synchronous FL round engine on one device.

One FL round = local gradients on every sampled client, the compression
scheme, aggregation, the server update. ``RoundEngine`` owns the round
function for a (FLConfig, CompressionConfig, loss) triple; the simulator
drives it and keeps the host-side bookkeeping (ledger, sampling, adaptive
tau). The ``vmap`` backend is ported; ``shard`` and ``async`` and the
non-star topologies raise ``NotImplementedError``.

Round function signature (the JAX package's, eager here):

    round_fn(params, cstates, sstate, gbar_prev, client_idx, batches,
             round_idx, lr, tau_now[, rates, wire_levels])
      -> (params, cstates, sstate, bcast, upload_nnz[k], download_nnz,
          union_nnz)

The trailing ``rates`` (float32 ``[k]``) and ``wire_levels`` (int32
``[k]``) are the adaptive rate controller's per-client outputs, passed
only under it (``rate_adaptive``; levels only when ``use_levels``).
Under a stochastic wire (``probquant``) the sampled ``client_idx`` rides
into the compression, so each client draws its own noise. A scheme that
``owns_lr`` (FetchSGD) applies the learning rate in its server step, and
its broadcast is the finished update.

Client gradients are ``torch.func.vmap`` of ``torch.func.grad`` over the
client axis; their tree is flattened with one ``torch.cat`` into a
``[k, N]`` stack of the params' ``FlatLayout`` (``utils/flat.py``), the
layout of the compression state. The compression then runs on the flat
stacks with the client axis written out (``Scheme.client_compress``), so
each compression kernel launches once a round for all k clients and all
leaves; the sampled clients' states move with one op per field (none
under a sketch, whose client state is empty); the payloads (``[k, N]``,
or ``[k, rows·cols]`` sketches) are summed with one ``sum(0)`` and the
server step turns the sum into the ``[N]`` broadcast, which updates the
params through views. Nothing in the round reads a device
value on the host; the counts come back as device tensors.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import (
    gather_client_states,
    resolve,
    scatter_client_states,
)
from repro_torch.core.stages import ENGINES
from repro_torch.utils import tree_map

BACKENDS = ("vmap", "shard", "async")
TOPOLOGIES = ("star", "ring", "hierarchical")


class RoundEngine:
    """Owns the round step for one backend; consumes the compression
    scheme as a protocol object (``repro_torch.core.resolve(comp_cfg)``)."""

    name = "base"

    def __init__(self, fl_cfg, comp_cfg, loss_fn: Callable, sampled_per_round: int, layout):
        self.fl = fl_cfg
        self.comp = comp_cfg
        self.scheme = resolve(comp_cfg)
        self.loss_fn = loss_fn
        self.sampled_per_round = sampled_per_round
        self.layout = layout  # the params' FlatLayout
        # whether the simulator threads per-client rates, and wire levels
        self.rate_adaptive = self.scheme.rate_adaptive
        self.use_levels = self.rate_adaptive and float(comp_cfg.rate_wire_threshold) > 0.0
        # whether the wire codec keys its draws by client
        self.thread_client_ids = self.scheme.wire.stochastic
        self.round_fn = self._build()

    def _grads(self, params, batches):
        """Local gradients for a stack of clients (leading axis)."""
        grad_fn = torch.func.grad(self.loss_fn)
        return torch.func.vmap(grad_fn, in_dims=(None, 0))(params, batches)

    def _compress_stack(self, states, grads, gbar_prev, round_idx, tau_now, client_ids=None,
                        rates=None, levels=None):
        """``client_compress`` over the whole ``[k, N]`` stack at once."""
        tau_kw = {"tau_override": tau_now} if self.fl.adaptive_tau else {}
        return self.scheme.client_compress(states, grads, gbar_prev, round_idx, rates=rates,
                                           wire_levels=levels, client_ids=client_ids,
                                           layout=self.layout, **tau_kw)

    def _client_update(self, params, states, batches, gbar_prev, round_idx, tau_now,
                       client_ids=None, rates=None, levels=None):
        grads = self.layout.flatten(self._grads(params, batches))
        return self._compress_stack(states, grads, gbar_prev, round_idx, tau_now, client_ids,
                                    rates, levels)

    def _server_update(self, params, sstate, g_sum, lr):
        bcast, sstate, ainfo = self.scheme.server_aggregate(
            sstate, g_sum, float(self.sampled_per_round), layout=self.layout, lr=lr)
        # a scheme that owns lr applied it in its server step (1.0 · g is g)
        step = 1.0 if self.scheme.owns_lr else lr
        params = tree_map(lambda w, g: w - step * g.to(w.dtype), params,
                          self.layout.unflatten(bcast))
        return params, sstate, bcast, ainfo

    def _build(self):
        raise NotImplementedError


class VmapEngine(RoundEngine):
    """Single-device path: all sampled clients as one stack."""

    name = "vmap"

    def _build(self):
        @torch.no_grad()
        def round_fn(params, cstates, sstate, gbar_prev, client_idx, batches,
                     round_idx, lr, tau_now, rates=None, wire_levels=None):
            sampled = gather_client_states(cstates, client_idx)
            G, new_states, infos = self._client_update(
                params, sampled, batches, gbar_prev, round_idx, tau_now,
                client_idx if self.thread_client_ids else None, rates, wire_levels)
            cstates = scatter_client_states(cstates, client_idx, new_states)
            g_sum = torch.sum(G, dim=0)
            params, sstate, bcast, ainfo = self._server_update(params, sstate, g_sum, lr)
            return (params, cstates, sstate, bcast, infos.upload_nnz,
                    ainfo.download_nnz, ainfo.union_nnz)

        return round_fn


def make_engine(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout) -> RoundEngine:
    """Factory keyed on ``fl_cfg.backend`` and ``fl_cfg.topology``;
    ``layout`` is the params' ``FlatLayout``."""
    if fl_cfg.topology != "star" or fl_cfg.backend != "vmap":
        raise NotImplementedError(
            f"backend={fl_cfg.backend!r} topology={fl_cfg.topology!r} is not ported "
            f"yet (only vmap on a star): {ENGINES}")
    return VmapEngine(fl_cfg, comp_cfg, loss_fn, sampled_per_round, layout)


__all__ = ["BACKENDS", "TOPOLOGIES", "RoundEngine", "VmapEngine", "make_engine"]
