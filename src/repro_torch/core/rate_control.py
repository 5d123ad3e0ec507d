"""Adaptive per-client compression-rate control, a copy of the JAX
package's ``core/rate_control.py`` on device tensors.

The ``rate_control`` stage kind: a stateless singleton per policy whose
mutable quantities live in a ``RateControlState`` of ``[num_clients]``
device tensors. The simulator runs the controller once a round before the
round function and hands the engine per-sampled-client rates ``[k]`` and
wire levels ``[k]`` (0 = the scheme's wire codec, 1 = drop to int8 for
this round), as device tensors: nothing is read on the host here.

Inputs per round: ``signal``, each sampled client's EF-residual mass
against the global delta norm ``‖V_k‖ / (‖Ĝ_prev‖ + eps)``; ``bandwidth``,
the availability model's budget in (0, 1] (exact ones under ``none``);
``gap``, the staleness of the cohort's snapshot (0.0 on the synchronous
engine). The ``adaptive`` law, per sampled client k::

    ref     = midrange(signal)               # (max + min) / 2
    boost_k = 1 + rate_gain * (signal_k - ref) / (|ref| + eps)
    rate_k  = clip(rate * boost_k * bandwidth_k * (1 + gap)^(-gamma),
                   rate_min, rate_max)

When every client reports the same signal, ``ref == signal_k`` bitwise,
each factor is exactly 1 and ``rate_k`` is bitwise ``cfg.rate``. A client
whose EMA'd signal sits below ``rate_wire_threshold`` drops to the int8
wire for the round. The EMA warm-starts at a client's first observation.

Every operation is the reference's float32 operation in its order, and
every division is by a device tensor (CUDA divides by a Python scalar as a
product with its reciprocal, one rounding off), so the rates are bitwise
JAX's on the same inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.stages import register
from repro_torch.utils.device import scalar


class RateControlState(NamedTuple):
    """Controller state over ALL clients: ``ema`` float32 ``[K]`` (EMA of
    each client's signal), ``seen`` int32 ``[K]`` (times observed),
    ``rounds`` int32 ``()`` (updates so far)."""

    ema: torch.Tensor
    seen: torch.Tensor
    rounds: torch.Tensor


def init_state(num_clients: int, device="cpu") -> RateControlState:
    return RateControlState(
        ema=torch.zeros(num_clients, dtype=torch.float32, device=device),
        seen=torch.zeros(num_clients, dtype=torch.int32, device=device),
        rounds=torch.zeros((), dtype=torch.int32, device=device),
    )


class RateController:
    """``update(cfg, state, client_idx, signal, bandwidth, gap) ->
    (new_state, rates [k] float32, wire_levels [k] int32)``, pure over the
    state; ``client_idx`` are the sampled clients' global ids (int64
    ``[k]``, distinct), the other inputs float32 tensors on one device."""

    name = "base"
    description = ""

    def init(self, cfg, num_clients: int, device="cpu") -> RateControlState:
        return init_state(num_clients, device)

    def _track(self, cfg, state, client_idx, signal):
        """The EMA bookkeeping: warm start at the first observation, decay
        ``rate_ema`` after. Returns (new state, the cohort's EMA)."""
        sig = signal.float()
        prev = state.ema.index_select(0, client_idx)
        first = state.seen.index_select(0, client_idx) == 0
        obs = torch.where(first, sig, cfg.rate_ema * prev + (1.0 - cfg.rate_ema) * sig)
        ones = torch.ones_like(client_idx, dtype=state.seen.dtype)
        return RateControlState(
            ema=state.ema.index_copy(0, client_idx, obs),
            seen=state.seen.index_add(0, client_idx, ones),
            rounds=state.rounds + 1,
        ), obs

    def update(self, cfg, state, client_idx, signal, bandwidth, gap):
        raise NotImplementedError


@register("rate_control", "fixed")
class FixedRateController(RateController):
    description = ("every sampled client runs at cfg.rate with the scheme's own "
                   "wire codec — the paper's behaviour; the round threads no rates")

    def update(self, cfg, state, client_idx, signal, bandwidth, gap):
        state, _ = self._track(cfg, state, client_idx, signal)
        k, dev = client_idx.shape[0], client_idx.device
        rates = torch.full((k,), cfg.rate, dtype=torch.float32, device=dev)
        return state, rates, torch.zeros(k, dtype=torch.int32, device=dev)


@register("rate_control", "adaptive")
class AdaptiveRateController(RateController):
    description = ("CFedAvg-style signal-adaptive per-client rates: boost "
                   "clients whose EF-residual mass outruns the cohort "
                   "midrange, scale by the bandwidth budget, damp by "
                   "(1+gap)^(-rate_staleness_gamma); clients whose EMA'd "
                   "signal sits below rate_wire_threshold drop to the int8 "
                   "wire for the round")

    def update(self, cfg, state, client_idx, signal, bandwidth, gap):
        state, ema = self._track(cfg, state, client_idx, signal)
        sig = signal.float()
        dev = sig.device
        f32 = lambda x: scalar(x, dev)
        # midrange, not mean: it equals the common value exactly when the
        # signal is flat, which makes the flat fixed point bitwise
        ref = 0.5 * (torch.max(sig) + torch.min(sig))
        boost = 1.0 + f32(cfg.rate_gain) * ((sig - ref) / (torch.abs(ref) + f32(cfg.eps)))
        damp = (1.0 + f32(gap)) ** (-f32(cfg.rate_staleness_gamma))
        rates = torch.clamp(f32(cfg.rate) * boost * bandwidth.float() * damp,
                            min=f32(cfg.rate_min), max=f32(cfg.rate_max))
        if cfg.rate_wire_threshold > 0.0:
            levels = (ema < cfg.rate_wire_threshold).to(torch.int32)
        else:
            levels = torch.zeros(client_idx.shape, dtype=torch.int32, device=dev)
        return state, rates, levels


__all__ = [
    "AdaptiveRateController",
    "FixedRateController",
    "RateControlState",
    "RateController",
    "init_state",
]
