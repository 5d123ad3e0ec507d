"""Adaptive per-client rate control in the port against the JAX package.

* The controllers (``core/rate_control.py``): rates, wire levels and the
  EMA state **bitwise** JAX's on injected signals, over successive updates.
* ``num_keep_dynamic`` equal to JAX's; the per-row keep thresholds of the
  plain versions of ``gmf_select`` (both modes) bitwise JAX's
  ``dynamic_threshold`` per leaf and client.
* The flat-signal identity: ``adaptive_dgcwgmf`` at zero gain is
  ``dgcwgmf`` bitwise in the port (params and ledger), as
  ``tests/test_rate_control.py`` pins for JAX.
* Per-client ledger value bytes with wire levels equal to JAX's ledger.
* Three adaptive rounds against JAX on a model with an exact elementwise
  gradient (``c + p``): wire levels, nnz and ledger equal; rates within
  1e-6 relative (the signal's norms are sums in another order); params
  within 1e-6 of each leaf's largest magnitude (jitted JAX contracts
  w − lr·g and αU + g into fused multiply-adds).
* On the card the round launches K2, one ``gmf_select`` in its |z| mode
  with a ``[k, L]`` keep table, and K3 (kernels stood in for by their plain
  versions).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import CommLedger as JLedger
from repro.core import CompressionConfig as JComp
from repro.core import sparsify as jsp
from repro.core.rate_control import init_state as jinit
from repro.core.stages import get_stage as jget
from repro.fl import FLConfig as JFL
from repro.fl import FLSimulator as JSim
from repro.fl import availability as javail
from repro_torch.core import CommLedger as TLedger
from repro_torch.core import CompressionConfig as TComp
from repro_torch.core import schemes as ts
from repro_torch.core import sparsify as tsp
from repro_torch.core.rate_control import init_state as tinit
from repro_torch.core.stages import get_stage as tget
from repro_torch.fl import FLConfig as TFL
from repro_torch.fl import FLSimulator as TSim
from repro_torch.fl import availability as tavail
from repro_torch.kernels import ops, ref
from repro_torch.utils.convert import from_jax_params
from repro_torch.utils.flat import FlatLayout

SHAPES = {"a": (300,), "b": (80,), "c": (16, 40), "e": (1,)}
LAYOUT = FlatLayout.of({k: torch.zeros(s) for k, s in SHAPES.items()})


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# the controllers
# ---------------------------------------------------------------------------

SIGNALS = [
    ([0, 3, 5, 6], [1.37, 1.37, 1.37, 1.37], [1, 1, 1, 1]),          # flat
    ([1, 2, 4, 7], [0.3, 2.0, 0.0, 17.5], [1, 1, 1, 1]),
    ([0, 3, 5, 7], [1e-3, 0.7, 0.71, 3.3], [0.5, 1, 0.25, 1 / 3]),   # repeats 0, 3, 5, 7
    ([2, 3, 6, 7], [4.0, 0.1, 2.2, 0.9], [1, 0.5, 1, 1]),
]


@pytest.mark.parametrize("name", ["adaptive", "fixed"])
@pytest.mark.parametrize("kw", [
    dict(rate=0.1),
    dict(rate=0.1, rate_gain=2.0, rate_min=0.02, rate_max=0.3, rate_wire_threshold=1.0),
    dict(rate=0.37, rate_gain=0.7, rate_ema=0.6, rate_wire_threshold=0.5),
], ids=["default", "clamped-levels", "nondyadic"])
def test_controller_bitwise_over_updates(name, kw):
    """Four successive updates from the same state: rates, levels and the
    EMA/count state bitwise JAX's (gap 0.0 and 0.5)."""
    jcfg, tcfg = JComp(scheme="adaptive_dgcwgmf", **kw), TComp(scheme="adaptive_dgcwgmf", **kw)
    jctl, tctl = jget("rate_control", name), tget("rate_control", name)
    jst, tst = jinit(8), tinit(8)
    for gap in (0.0, 0.5):
        for ids, sig, bw in SIGNALS:
            f32 = lambda x: np.asarray(x, np.float32)
            jst, jr, jl = jctl.update(jcfg, jst, jnp.asarray(ids, jnp.int32), jnp.asarray(f32(sig)),
                                      jnp.asarray(f32(bw)), jnp.asarray(gap, jnp.float32))
            tst, tr, tl = tctl.update(tcfg, tst, torch.tensor(ids), torch.from_numpy(f32(sig)),
                                      torch.from_numpy(f32(bw)), torch.tensor(gap))
            assert np.array_equal(_bits(tr.numpy()), _bits(jr)), (gap, ids)
            assert np.array_equal(tl.numpy(), np.asarray(jl))
            assert np.array_equal(_bits(tst.ema.numpy()), _bits(jst.ema))
            assert np.array_equal(tst.seen.numpy(), np.asarray(jst.seen))
            assert int(tst.rounds) == int(jst.rounds)
    assert tr.dtype == torch.float32 and tl.dtype == torch.int32


def test_bandwidth_copy_draws_as_the_reference():
    for model, mean in (("none", 0.0), ("uniform", 1.5), ("geometric", 1.0), ("lognormal", 2.0)):
        a = javail.Availability(model=model, mean=mean, max_delay=3)
        b = tavail.Availability(model=model, mean=mean, max_delay=3)
        ra, rb = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(3):
            assert np.array_equal(a.sample_bandwidth(ra, 6), b.sample_bandwidth(rb, 6)), model
    # under `none` the budget is exact ones and nothing is drawn
    rng = np.random.default_rng(1)
    state = rng.bit_generator.state
    assert np.array_equal(tavail.Availability().sample_bandwidth(rng, 4), np.ones(4))
    assert rng.bit_generator.state == state


# ---------------------------------------------------------------------------
# dynamic keep counts and per-row keep thresholds
# ---------------------------------------------------------------------------


def test_num_keep_dynamic_equals_jax():
    ns = [1, 2, 7, 80, 256, 1000, 36_864, 292_560, 2**24 + 3]
    rates = np.asarray([1e-4, 0.01, 0.05, 0.1, 1 / 3, 0.37, 0.5, 0.999, 1.0], np.float32)
    got = tsp.num_keep_dynamic(torch.tensor(ns)[:, None], torch.from_numpy(rates)[None, :])
    want = np.asarray([[int(jsp.num_keep_dynamic(n, r)) for r in rates] for n in ns])
    assert np.array_equal(got.numpy(), want)
    table = tsp.keep_table(LAYOUT, torch.from_numpy(rates))
    assert table.shape == (len(rates), LAYOUT.num_leaves) and table.dtype == torch.int64
    assert np.array_equal(table.numpy(), [[int(jsp.num_keep_dynamic(n, r)) for n in LAYOUT.sizes]
                                          for r in rates])


def _stack(seed, k, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, LAYOUT.total))
    if ties:
        x = np.round(x * 4) / 4  # many equal magnitudes at the thresholds
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("ties", [True, False])
def test_per_row_keep_abs_thresholds_equal_jax_dynamic_threshold(ties):
    rates = torch.tensor([0.1, 0.37, 1.0, 1e-4, 0.5])
    z = _stack(0, 5, ties)
    keep = tsp.keep_table(LAYOUT, rates)
    thr, mask = ops.topk_abs_select(z, LAYOUT, keep=keep)
    for i, seg in enumerate(LAYOUT.segments(z)):
        for r in range(5):
            want = jsp.dynamic_threshold(jnp.abs(jnp.asarray(seg[r].numpy())), rates[r].item())
            assert _bits(thr[r, i].item()) == _bits(want), (r, i)
    want_mask = jsp.topk_mask_dynamic(jnp.asarray(z.numpy()[1, :300]), 0.37)
    assert np.array_equal(mask[1, :300].numpy(), np.asarray(want_mask))
    # the dynamic path agrees with the fixed one at a shared rate
    same = torch.full((5,), 0.25)
    fixed = ops.topk_abs_select(z, LAYOUT, 0.25)
    dyn = ops.topk_abs_select(z, LAYOUT, keep=tsp.keep_table(LAYOUT, same))
    assert all(torch.equal(a, b) for a, b in zip(fixed, dyn, strict=True))
    with pytest.raises(ValueError, match="exactly one"):
        ops.topk_abs_select(z, LAYOUT, 0.1, keep=keep)


def test_per_row_keep_gmf_select_thresholds_equal_jax_dynamic_threshold():
    """``gmf_select``'s plain version with a per-row table: the threshold of
    each segment is JAX's ``dynamic_threshold`` of the z its scalars give."""
    v, m = _stack(1, 4), _stack(2, 4)
    rates = torch.tensor([0.05, 0.1, 0.3, 0.9])
    w, tau = torch.tensor([1.0, 0.5, 2.0, 1.0]), torch.tensor([0.0, 0.3, 0.6, 1.0])
    inv_nv, inv_nm, thr = ops.gmf_select(v, m, LAYOUT, keep=tsp.keep_table(LAYOUT, rates), w=w,
                                         tau=tau, eps=1e-16)
    z = ref.gmf_fusion_score(v, m, inv_norm_v=LAYOUT.expand(inv_nv),
                             inv_norm_m=LAYOUT.expand(inv_nm), tau=tau)
    for i, seg in enumerate(LAYOUT.segments(z)):
        for r in range(4):
            want = jsp.dynamic_threshold(jnp.asarray(seg[r].numpy()), rates[r].item())
            assert _bits(thr[r, i].item()) == _bits(want), (r, i)
    p_nv, p_nm, _ = ops.gmf_select(v, m, LAYOUT, 0.1, w=w, tau=tau, eps=1e-16)
    assert torch.equal(p_nv, inv_nv) and torch.equal(p_nm, inv_nm)


def test_global_topk_at_per_client_rates_equals_jax():
    z = _stack(3, 3)
    rates = torch.tensor([0.1, 0.25, 0.6])
    got = tsp.topk_mask_dynamic(z, rates)
    for r in range(3):
        masks = jsp.global_topk_masks_dynamic(
            [jnp.asarray(s[r].numpy()) for s in LAYOUT.segments(z)], rates[r].item())
        assert np.array_equal(got[r].numpy(), np.concatenate([np.asarray(x) for x in masks]))


# ---------------------------------------------------------------------------
# the ledger's per-client value bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_ledger_value_bytes_with_levels_equal_jax(wire):
    from repro.core.accounting import CostModel as JCost
    from repro_torch.core.accounting import CostModel as TCost

    vb = float(tget("wire", wire).value_bytes)
    assert vb == float(jget("wire", wire).value_bytes)
    jl, tl = JLedger(JCost(value_bytes=vb)), TLedger(TCost(value_bytes=vb))
    rounds = [([29_258, 43_885, 14_630], [1, 0, 1]), ([292_560, 7, 150_000], [0, 1, 1]),
              ([10, 20, 30], [0, 0, 0])]
    for nnz, levels in rounds:
        value_bytes = np.where(np.asarray(levels) > 0, 1.0, vb)
        jl.record_round(np.asarray(nnz), 20_000.0, 292_560, 3, value_bytes=value_bytes)
        tl.record_round(np.asarray(nnz), 20_000.0, 292_560, 3, value_bytes)
        assert tl.upload_bytes == jl.upload_bytes and tl.download_bytes == jl.download_bytes
    # a dropped client is charged 1 byte a value: the first round costs
    # less than at the wire's own value bytes
    up, _ = TCost(value_bytes=vb).round_bytes(np.asarray(rounds[0][0]), 0, 292_560, 3)
    first = TLedger(TCost(value_bytes=vb))
    first.record_round(np.asarray(rounds[0][0]), 0, 292_560, 3,
                       np.where(np.asarray(rounds[0][1]) > 0, 1.0, vb))
    assert first.upload_bytes < up


# ---------------------------------------------------------------------------
# simulator rounds
# ---------------------------------------------------------------------------

MODEL = {"w": (24, 40), "b": (40,), "h": (40, 7)}
FL = dict(num_clients=6, rounds=3, clients_per_round=4, batch_size=1, learning_rate=0.5,
          seed=0)


def _init_np():
    rng = np.random.default_rng(0)
    return {n: (rng.normal(size=s) * 0.1).astype(np.float32) for n, s in MODEL.items()}


def _jax_loss(p, batch):
    # d/dp [sum(p * c) + 0.5 * sum(p^2)] = c + p, exact elementwise float32
    return sum(jnp.sum(p[n] * batch[n][0]) + 0.5 * jnp.sum(jnp.square(p[n])) for n in MODEL)


def _torch_loss(p, batch):
    return sum(torch.sum(p[n] * batch[n][0]) + 0.5 * torch.sum(torch.square(p[n]))
               for n in MODEL)


def _batches(to):
    def provide(t, ids, rng):
        return {n: to(rng.normal(size=(len(ids), 1, *s)).astype(np.float32))
                for n, s in MODEL.items()}

    return provide


def _port_sim(**comp):
    init = _init_np()
    sim = TSim(TFL(**FL), TComp(**comp), lambda gen: from_jax_params(init, layout="lstm"),
               _torch_loss, device="cpu")
    sim.run(_batches(torch.from_numpy))
    return sim


def _jax_sim(**comp):
    init = _init_np()
    sim = JSim(JFL(**FL), JComp(**comp), lambda key: {n: jnp.asarray(x) for n, x in init.items()},
               _jax_loss)
    sim.run(_batches(jnp.asarray))
    return sim


def test_gain_zero_adaptive_is_dgcwgmf_bitwise():
    """Flat fixed point: gain 0 under unit bandwidth makes every rate
    exactly cfg.rate, and the dynamic-k path is the fixed path's
    computation at rate 0.25 (dyadic), so params and ledger are bitwise."""
    adaptive = _port_sim(scheme="adaptive_dgcwgmf", rate=0.25, rate_gain=0.0)
    fixed = _port_sim(scheme="dgcwgmf", rate=0.25)
    assert adaptive.rate_adaptive and not fixed.rate_adaptive
    for n in MODEL:
        assert torch.equal(adaptive.params[n], fixed.params[n]), n
    assert adaptive.ledger.total_bytes == fixed.ledger.total_bytes
    assert all(r["rate_mean"] == 0.25 for r in adaptive.history)
    assert [r["upload_nnz"] for r in adaptive.history] == [r["upload_nnz"] for r in fixed.history]


def test_wire_level_drop_charges_fewer_upload_bytes():
    dropped = _port_sim(scheme="adaptive_dgcwgmf", rate=0.25, rate_gain=0.0,
                        rate_wire_threshold=1e9)
    fixed = _port_sim(scheme="dgcwgmf", rate=0.25)
    assert dropped.ledger.upload_bytes < fixed.ledger.upload_bytes
    assert all(r["wire_levels"] == [1, 1, 1, 1] for r in dropped.history)
    assert all(bool(torch.isfinite(x).all()) for x in dropped.params.values())


def test_adaptive_rounds_match_jax():
    """The EMA is the latest signal (rate_ema 0), and the threshold sits
    among the signals (1.0-1.6 here), so rounds 1 and 2 mix int8 and
    float32 clients."""
    kw = dict(scheme="adaptive_dgcwgmf", rate=0.25, rate_gain=0.5, rate_ema=0.0,
              rate_wire_threshold=1.2)
    jsim, tsim = _jax_sim(**kw), _port_sim(**kw)
    assert [r["rate_mean"] for r in tsim.history] == pytest.approx(
        [r["rate_mean"] for r in jsim.history], rel=1e-6, abs=0)
    assert any(r["rate_mean"] != 0.25 for r in tsim.history[1:])
    assert any(0 in r["wire_levels"] and 1 in r["wire_levels"] for r in tsim.history)
    assert [r["comm_gb"] for r in tsim.history] == [r["comm_gb"] for r in jsim.history]
    assert tsim.ledger.upload_bytes == jsim.ledger.upload_bytes
    assert np.array_equal(tsim.rate_state.seen.numpy(), np.asarray(jsim.rate_state.seen))
    np.testing.assert_allclose(tsim.rate_state.ema.numpy(), np.asarray(jsim.rate_state.ema),
                               rtol=1e-6)
    for n in MODEL:
        want = np.asarray(jsim.params[n])
        np.testing.assert_allclose(tsim.params[n].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_adaptive_card_path_launches_k2_select_k3_once(monkeypatch):
    """``client_compress`` at per-client rates as it runs on the card
    (``kernels.ops`` taking every tensor for a CUDA one), kernels stood in
    for by their plain versions: K2, one ``gmf_select`` in its |z| mode
    with a ``[k, L]`` keep table, K3 — even with ``use_kernels``, as the
    reference sends a traced rate to the staged path."""
    from repro_torch.kernels import gmf_compress as gk

    calls, tables = {}, []

    def kernel(name, plain):
        def run(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return plain(*args, **kw)
        return run

    def select_abs(z, *, offsets, plan, keep, group):
        tables.append(keep)
        return tsp.segment_topk_mask_keep(z, LAYOUT, keep)

    monkeypatch.setattr(ops, "_on_card", lambda x: True)
    monkeypatch.setattr(gk, "topk_abs_select_flat", kernel("gmf_select", select_abs))
    monkeypatch.setattr(gk, "gmf_select_flat", kernel("gmf_select_fused", None))
    monkeypatch.setattr(gk, "apply_mask_flat", kernel("apply_mask", ref.apply_mask_update_leaf))
    monkeypatch.setattr(gk, "momentum_correction_tree", kernel(
        "momentum_correction", lambda us, vs, gs, a: tuple(
            map(list, zip(*(ref.momentum_correction_leaf(*x, a) for x in zip(us, vs, gs)))))))
    cfg = TComp(scheme="adaptive_dgcwgmf", rate=0.1, tau=0.6, use_kernels=True)
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    state, _ = ts.init_states(cfg, params)
    state = type(state)(*(f.expand(4, -1).clone() if torch.is_tensor(f) else f for f in state))
    rates = torch.tensor([0.05, 0.1, 0.2, 0.4])
    grad, gbar = _stack(4, 4, ties=False), _stack(5, 1, ties=False)[0]
    g, _, info = ts.client_compress(cfg, state, grad, gbar, 1, rates=rates,
                                    wire_levels=torch.tensor([0, 1, 0, 1]), layout=LAYOUT)
    assert calls == {"momentum_correction": 1, "gmf_select": 1, "apply_mask": 1}
    assert tables[0].shape == (4, LAYOUT.num_leaves)
    assert info.upload_nnz.tolist() == tables[0].sum(1).tolist()
