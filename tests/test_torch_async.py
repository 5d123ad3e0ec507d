"""The port's asynchronous buffered engine, staleness stages, availability
draws and split ledger against the JAX package's.

The model is a linear-softmax classifier on fixed numpy data (the JAX
package's own async tests use it), its params drawn by JAX and converted.

Tolerances:
- availability draws, cohorts, the async schedule (applies, pending, in
  flight, the staleness histogram) and every ledger byte: exact (the draws
  are the same numpy calls; the counts come from exact top-k masks);
- zero-delay async vs the port's vmap run, the encoded queue vs the dense
  one, gap 0 vs the identity: bitwise (the same float32 operations);
- the staleness weights ``(1 + s)^(−e)``: within 2 float32 ulps (2.4e-7
  relative) of JAX's, since ``pow`` may round differently from XLA's; the
  combines, which multiply payloads by them, within 5e-7 relative;
- params after whole runs: within 1e-5 of each leaf's largest magnitude
  (the port is eager; jitted JAX contracts ``w·g + λ·M`` and the momentum
  EMA into FMAs, one rounding apart, ROADMAP R3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import CommLedger as JLedger  # noqa: E402
from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.core import resolve as jresolve  # noqa: E402
from repro.fl import Availability as JAvail  # noqa: E402
from repro.fl import FLConfig as JFL  # noqa: E402
from repro.fl import FLSimulator as JSim  # noqa: E402
from repro_torch.core import CommLedger, CompressionConfig, resolve  # noqa: E402
from repro_torch.core import registry, stages  # noqa: E402
from repro_torch.core.accounting import CostModel  # noqa: E402
from repro_torch.fl import DELAY_MODELS, Availability, FLConfig, FLSimulator  # noqa: E402
from repro_torch.fl.engine import AsyncBufferedEngine  # noqa: E402
from repro_torch.utils.convert import from_jax_params, to_jax_params  # noqa: E402

D_IN, D_OUT = 12, 4
COMP = dict(rate=0.25, tau=0.4)


class Tiny:
    """Linear-softmax classifier on fixed random data, in both packages."""

    def __init__(self, num_clients, samples=16, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(num_clients, samples, D_IN)).astype(np.float32)
        self.y = rng.integers(0, D_OUT, size=(num_clients, samples))
        self.tx, self.ty = torch.from_numpy(self.x), torch.from_numpy(self.y)
        key = jax.random.split(jax.random.PRNGKey(0))[0]
        self.jparams = {"w": 0.1 * jax.random.normal(key, (D_IN, D_OUT)),
                        "b": jnp.zeros((D_OUT,))}

    def jax_init(self, key):
        return self.jparams

    def torch_init(self, gen):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, self.jparams),
                               layout="transformer")

    @staticmethod
    def jax_loss(params, batch):
        x, y = batch
        logp = jax.nn.log_softmax(x @ params["w"] + params["b"], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    @staticmethod
    def torch_loss(params, batch):
        x, y = batch
        logp = torch.log_softmax(x @ params["w"] + params["b"], dim=-1)
        return -torch.mean(torch.gather(logp, -1, y[..., None]))

    def jax_provider(self):
        return lambda t, ids, rng: (jnp.asarray(self.x[ids]), jnp.asarray(self.y[ids]))

    def torch_provider(self):
        return lambda t, ids, rng: (self.tx[torch.as_tensor(ids)], self.ty[torch.as_tensor(ids)])


def _fl(num_clients=8, clients_per_round=4, rounds=5, **kw):
    return dict(num_clients=num_clients, rounds=rounds, clients_per_round=clients_per_round,
                batch_size=16, learning_rate=0.5, seed=0, **kw)


def _port(scheme="dgcwgmf", comp_kw=None, encode=True, **fl_kw):
    fl = _fl(**fl_kw)
    task = Tiny(fl["num_clients"])
    sim = FLSimulator(FLConfig(**fl), CompressionConfig(scheme=scheme, **COMP, **(comp_kw or {})),
                      task.torch_init, task.torch_loss, device="cpu")
    if isinstance(sim.engine, AsyncBufferedEngine):
        sim.engine.encode_queue = encode
    sim.run(task.torch_provider())
    return sim


def _jax(scheme="dgcwgmf", comp_kw=None, **fl_kw):
    fl = _fl(**fl_kw)
    task = Tiny(fl["num_clients"])
    sim = JSim(JFL(**fl), JComp(scheme=scheme, **COMP, **(comp_kw or {})), task.jax_init,
               task.jax_loss)
    sim.run(task.jax_provider())
    return sim


def _state(sim):
    """Every tensor a run leaves, by name."""
    out = {f"params/{k}": v for k, v in sim.params.items()}
    for name, x in zip("uvm", sim.cstates, strict=True):
        if torch.is_tensor(x):
            out[f"client/{name}"] = x
    for name, x in zip(("momentum", "residual"), sim.sstate, strict=True):
        if torch.is_tensor(x):
            out[f"server/{name}"] = x
        elif isinstance(x, dict):
            out.update({f"server/{name}/{k}": v for k, v in x.items()})
    out["gbar_prev"] = sim.gbar_prev
    return out


def _assert_bitwise(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


# ---------------------------------------------------------------------------
# availability
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", DELAY_MODELS)
def test_availability_draws_match_jax(model):
    kw = dict(model=model, mean=1.5, max_delay=4, dropout=0.2)
    a, b = JAvail(**kw), Availability(**kw)
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    for k in (1, 5, 20):
        assert np.array_equal(a.sample_delays(ra, k), b.sample_delays(rb, k))
        assert np.array_equal(a.sample_dropout(ra, k), b.sample_dropout(rb, k))
        assert np.array_equal(a.sample_bandwidth(ra, k), b.sample_bandwidth(rb, k))
    assert ra.random() == rb.random()  # the streams stayed in step


@pytest.mark.parametrize("kw", [dict(model="poisson"), dict(mean=-1.0), dict(max_delay=-1),
                                dict(dropout=1.0), dict(dropout=-0.1)])
def test_availability_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JAvail(**kw)
    with pytest.raises(ValueError) as got:
        Availability(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# staleness stages
# ---------------------------------------------------------------------------

GAPS = np.asarray([0.0, 1.0, 3.0, 40.0, 32.0])  # 40 clips to the horizon, 32


@pytest.mark.parametrize("policy", ["poly", "gmf_damp"])
def test_staleness_weights_and_combines_match_jax(policy):
    rng = np.random.default_rng(3)
    buf = rng.normal(size=(len(GAPS), 52)).astype(np.float32)
    gmom = rng.normal(size=52).astype(np.float32)
    jcfg = JComp(scheme="async_dgcwgmf", staleness_stage=policy, staleness_exponent=0.7,
                 staleness_tau=0.4)
    tcfg = CompressionConfig(scheme="async_dgcwgmf", staleness_stage=policy,
                             staleness_exponent=0.7, staleness_tau=0.4)
    jst, tst = jresolve(jcfg), resolve(tcfg)
    gaps = torch.from_numpy(GAPS.astype(np.float32))
    w_j = np.asarray(jax.vmap(jst.staleness_weight)(jnp.asarray(GAPS)))
    w_t = tst.staleness_weight(gaps).numpy()
    np.testing.assert_allclose(w_t, w_j, rtol=2.4e-7, atol=0)
    assert w_t[0] == 1.0 and w_t[3] == w_t[4]  # the identity at 0; the horizon clip
    jgmom = {"w": jnp.asarray(gmom)} if policy == "gmf_damp" else {}
    out_j = np.asarray(jst.apply_staleness({"w": jnp.asarray(buf)}, jnp.asarray(GAPS),
                                           jgmom)["w"])
    tgmom = torch.from_numpy(gmom) if policy == "gmf_damp" else None
    out_t = tst.apply_staleness(torch.from_numpy(buf), gaps, tgmom).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=5e-7, atol=5e-7)
    assert np.array_equal(out_t[0], buf[0])  # gap 0: the payload itself


@pytest.mark.parametrize("policy", ["none", "poly", "gmf_damp"])
def test_staleness_gap_zero_is_the_identity(policy):
    scheme = resolve(CompressionConfig(scheme="async_dgcwgmf", staleness_stage=policy))
    buf = torch.tensor([[1.5, -2.0, 0.0, 3e-38], [7.0, -1e30, 2.0, 0.25]])
    out = scheme.apply_staleness(buf, torch.zeros(2), torch.full((4,), 10.0))
    assert torch.equal(out, buf)
    if policy == "none":
        assert out is buf


def test_every_stage_and_preset_is_ported():
    assert stages.NOT_PORTED == {} and registry.NOT_PORTED_PRESETS == {}
    assert set(stages.available("staleness")) == {"none", "poly", "gmf_damp"}
    assert resolve(CompressionConfig(scheme="async_dgcwgmf")).staleness_momentum


# ---------------------------------------------------------------------------
# the ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("up, down, total, vb", [
    ([120.0, 340.0, 99.0, 512.0], 900.0, 10_000, None),
    ([7000.0, 1.0], 10_000.0, 10_000, [1.0, 4.0]),
    ([2**31 + 7], 2**33, 10**10, None)])
def test_record_round_equals_its_decomposition(up, down, total, vb):
    a, b = CommLedger(CostModel()), CommLedger(CostModel())
    a.record_round(np.asarray(up), down, total, len(up), vb)
    b.record_upload(np.asarray(up), total, vb)
    b.record_download(down, total, len(up))
    b.tick()
    assert a.summary() == b.summary()
    assert (a.upload_bytes, a.download_bytes) == (b.upload_bytes, b.download_bytes)


def test_split_ledger_matches_jax():
    ja, ta = JLedger(), CommLedger(CostModel())
    for led in (ja, ta):
        led.record_upload(np.asarray([10.0, 600.0]), 1000)
        led.record_peer(np.asarray([30.0, 40.0, 900.0]), 1000)
        led.record_download(250.0, 1000, 4)
        led.record_peer_download(250.0, 1000, 8)
        led.record_staleness(np.asarray([0.0, 3.0, 3.0, 1.0]))
        led.tick()
    assert ta.summary() == ja.summary()
    assert ta.peer_bytes == ja.peer_bytes and ta.total_bytes == ja.total_bytes


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["dgcwgmf", "async_dgcwgmf", "fetchsgd"])
def test_zero_delay_async_is_vmap_bitwise(scheme):
    comp_kw = {"sketch_cols": 64} if scheme == "fetchsgd" else None
    a = _port(scheme, comp_kw, clients_per_round=8)
    b = _port(scheme, comp_kw, clients_per_round=8, backend="async")
    _assert_bitwise(a, b)
    assert a.ledger.summary() == {k: v for k, v in b.ledger.summary().items()
                                  if not k.startswith("staleness")}
    assert b.ledger.staleness_summary()["staleness_hist"] == {0: 5 * 8}


def test_zero_delay_async_partial_participation_is_vmap_bitwise():
    a = _port(num_clients=10, clients_per_round=4)
    b = _port(num_clients=10, clients_per_round=4, backend="async")
    _assert_bitwise(a, b)
    assert a.ledger.total_bytes == b.ledger.total_bytes


STRAGGLERS = dict(backend="async", delay_model="geometric", delay_mean=1.0, delay_max=4,
                  dropout_rate=0.2, buffer_size=3, rounds=6)


@pytest.mark.parametrize("wire, extra, store", [
    ("float32", {}, torch.float32), ("float16", {}, torch.float16),
    ("bfloat16", {}, torch.bfloat16),
    # the rotation's inverse follows the wire's rounding: float32 values
    ("float16", {"rotation_stage": "hadamard"}, torch.float32),
    # clients dropped to int8 send dequantised float32 values
    ("bfloat16", {"rate_control_stage": "adaptive", "rate_wire_threshold": 0.9},
     torch.float32)])
def test_encoded_queue_is_the_dense_queue_bitwise(wire, extra, store):
    comp_kw = {"wire_dtype": wire, **extra}
    records = []
    inner = AsyncBufferedEngine._encode

    def spy(self, G, nonzero, rows):
        out = inner(self, G, nonzero, rows)
        records.extend(out.values())
        return out

    AsyncBufferedEngine._encode = spy
    try:
        enc = _port("async_dgcwgmf", comp_kw, **STRAGGLERS)
    finally:
        AsyncBufferedEngine._encode = inner
    dense = _port("async_dgcwgmf", comp_kw, encode=False, **STRAGGLERS)
    _assert_bitwise(enc, dense)
    assert enc.ledger.summary() == dense.ledger.summary()
    assert [r["applies"] for r in enc.history] == [r["applies"] for r in dense.history]
    # one flat row each: rate 0.25 leaves sparse rows (indices and values),
    # the rotation dense ones
    kind = "dense" if "rotation_stage" in extra else "sparse"
    assert records and all(r[0] == kind and r[-1].dtype == store and r[-1].dim() == 1
                           and (kind == "dense" or r[1].dtype == torch.int32)
                           for r in records)


@pytest.mark.parametrize("scheme, comp_kw", [
    ("async_dgcwgmf", None),
    ("dgcwgmf", {"staleness_stage": "poly"}),
    ("adaptive_dgcwgmf", {"rate_wire_threshold": 0.9})])
def test_async_with_stragglers_matches_jax(scheme, comp_kw):
    j = _jax(scheme, comp_kw, **STRAGGLERS)
    t = _port(scheme, comp_kw, **STRAGGLERS)
    for key in ("applies", "pending", "in_flight", "staleness_mean"):
        assert [r.get(key) for r in t.history] == [r.get(key) for r in j.history], key
    assert sum(r["applies"] for r in t.history) >= 4
    assert any(g > 0 for g in t.ledger.staleness_counts)
    js, ts = j.ledger.summary(), t.ledger.summary()
    assert ts == js  # bytes, rounds and the staleness histogram
    assert set(r.get("round_ms") is not None for r in t.history) == {True}
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j.params))
    tp = jax.tree_util.tree_leaves(to_jax_params(t.params, layout="transformer"))
    for a, b in zip(jp, tp, strict=True):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
    if scheme == "async_dgcwgmf":
        jm = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j.engine._gmom))
        tm = t.layout.unflatten(t.engine._gmom)
        tm = jax.tree_util.tree_leaves(to_jax_params(tm, layout="transformer"))
        for a, b in zip(jm, tm, strict=True):
            assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


def test_rate_controller_sees_the_last_applied_gap_only_under_async():
    seen = []
    ctrl = stages.get_stage("rate_control", "adaptive")
    inner = type(ctrl).update

    def spy(self, cfg, state, ids, sig, bw, gap):
        seen.append(float(gap))
        return inner(self, cfg, state, ids, sig, bw, gap)

    type(ctrl).update = spy
    try:
        sync = _port("adaptive_dgcwgmf", rounds=4)
        sync_gaps, seen[:] = list(seen), []
        a = _port("adaptive_dgcwgmf", **STRAGGLERS)
    finally:
        type(ctrl).update = inner
    assert sync_gaps == [0.0] * 4 and "staleness_mean" not in sync.history[0]
    want, last = [], 0.0
    for rec in a.history:
        want.append(last)
        last = rec.get("staleness_mean", last)
    assert seen == [np.float32(g) for g in want] and max(want) > 0.0


def test_async_rejects_a_bad_buffer():
    with pytest.raises(ValueError, match="buffer_size"):
        FLConfig(num_clients=4, rounds=1, backend="async", buffer_size=-1)
    cfg = FLConfig(num_clients=4, rounds=1, backend="async")
    cfg.buffer_size = -2  # past the config's own check
    task = Tiny(4)
    with pytest.raises(ValueError, match="buffer_size must be >= 1"):
        FLSimulator(cfg, CompressionConfig(scheme="dgc"), task.torch_init, task.torch_loss,
                    device="cpu")
