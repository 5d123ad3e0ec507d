"""The port's ring and hierarchical topologies against the JAX package's.

The model is the linear-softmax classifier of tests/test_torch_async.py,
its params drawn by JAX and converted.

Tolerances:
- ``ring_hops=0`` and ``groups=1`` against the port's star run: bitwise
  (the same calls; one group sums with the star's own ``sum(0)``);
- ``group_sum``, ``interleave_position_stacks`` and ``inject_incoming``
  against JAX on numpy inputs: bitwise (the same float32 additions, in the
  same order over the reduced axis), except one group: the port's star sum
  bitwise, which is JAX's within 8 float32 ulps of the column's magnitude
  (8 rows summed in another order, as the port's star sum is already);
- whole ring and hierarchical runs against JAX's ``FLSimulator``: the
  upload (server-ingress), peer and download bytes exact (exact top-k
  counts), params within 1e-5 of each leaf's largest magnitude (the port
  is eager, jitted JAX contracts ``αU + g`` and the update into FMAs,
  ROADMAP R3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ClientState as JState  # noqa: E402
from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.core import group_sum as jgroup_sum  # noqa: E402
from repro.core import interleave_position_stacks as jinterleave  # noqa: E402
from repro.core import resolve as jresolve  # noqa: E402
from repro.core import resolve_tier as jresolve_tier  # noqa: E402
from repro.fl import FLConfig as JFL  # noqa: E402
from repro.fl import FLSimulator as JSim  # noqa: E402
from repro.topo import inject_incoming as jinject  # noqa: E402
from repro_torch.core import ClientState, CompressionConfig, group_sum  # noqa: E402
from repro_torch.core import interleave_position_stacks, resolve, resolve_tier  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulator, TopologyEngine  # noqa: E402
from repro_torch.topo import HierarchicalLayout, RingLayout, inject_incoming  # noqa: E402
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


def _fl(topology="star", num_clients=8, clients_per_round=8, rounds=5, **kw):
    return dict(num_clients=num_clients, rounds=rounds, clients_per_round=clients_per_round,
                batch_size=16, learning_rate=0.5, seed=0, topology=topology, **kw)


def _port(topology="star", scheme="dgcwgmf", comp_kw=None, **fl_kw):
    fl = _fl(topology, **fl_kw)
    task = Tiny(fl["num_clients"])
    sim = FLSimulator(FLConfig(**fl), CompressionConfig(scheme=scheme, **COMP, **(comp_kw or {})),
                      task.torch_init, task.torch_loss, device="cpu")
    sim.run(task.torch_provider())
    return sim


def _jax(topology="star", scheme="dgcwgmf", comp_kw=None, **fl_kw):
    fl = _fl(topology, **fl_kw)
    task = Tiny(fl["num_clients"])
    sim = JSim(JFL(**fl), JComp(scheme=scheme, **COMP, **(comp_kw or {})), task.jax_init,
               task.jax_loss)
    sim.run(task.jax_provider())
    return sim


def _state(sim):
    out = {f"params/{k}": v for k, v in sim.params.items()}
    for name, x in zip("uvm", sim.cstates, strict=True):
        if torch.is_tensor(x):
            out[f"client/{name}"] = x
    for name, x in zip(("momentum", "residual"), sim.sstate, strict=True):
        if torch.is_tensor(x):
            out[f"server/{name}"] = x
    out["gbar_prev"] = sim.gbar_prev
    return out


def _assert_bitwise(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key


# ---------------------------------------------------------------------------
# the star degeneracies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["dgcwgmf", "dgc"])
def test_ring_zero_hops_is_the_star_bitwise(scheme):
    a = _port("star", scheme)
    b = _port("ring", scheme, ring_hops=0)
    assert isinstance(b.engine, TopologyEngine)
    _assert_bitwise(a, b)
    assert (a.ledger.upload_bytes, a.ledger.download_bytes) == (b.ledger.upload_bytes,
                                                                b.ledger.download_bytes)
    assert b.ledger.peer_bytes == 0.0


@pytest.mark.parametrize("scheme", ["dgcwgmf", "dgc"])
def test_one_group_is_the_star_bitwise(scheme):
    a = _port("star", scheme)
    b = _port("hierarchical", scheme, groups=1)
    _assert_bitwise(a, b)
    assert b.engine.tier_scheme.name == "none"
    # one aggregator uploads the dense group sum; the leaves' payloads are peer bytes
    assert b.ledger.peer_bytes == a.ledger.upload_bytes + a.ledger.download_bytes


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_group_sum_matches_jax(groups):
    x = np.random.default_rng(groups).normal(size=(8, 301)).astype(np.float32)
    want = np.asarray(jgroup_sum(jnp.asarray(x), groups))
    got = group_sum(torch.from_numpy(x), groups).numpy()
    assert got.shape == (groups, 301)
    if groups > 1:
        assert np.array_equal(got, want)
    else:
        # the port's star sum, bitwise; JAX's star sums its 8 rows in another order
        assert np.array_equal(got[0], torch.sum(torch.from_numpy(x), dim=0).numpy())
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2**-23 * np.abs(x).sum(0).max())


@pytest.mark.parametrize("positions", [1, 2, 4])
def test_interleave_position_stacks_matches_jax(positions):
    rng = np.random.default_rng(positions)
    stacks = [rng.normal(size=(8 // positions, 5)).astype(np.float32) for _ in range(positions)]
    want = np.asarray(jinterleave([jnp.asarray(s) for s in stacks]))
    got = interleave_position_stacks([torch.from_numpy(s) for s in stacks])
    assert np.array_equal(got.numpy(), want)
    states = interleave_position_stacks([ClientState(u={}, v=torch.from_numpy(s), m={})
                                         for s in stacks])
    assert states.u == {} and np.array_equal(states.v.numpy(), want)
    layout = RingLayout(8, positions - 1)
    order = np.concatenate([layout.position_indices(p) for p in range(positions)])
    assert np.array_equal(np.concatenate(stacks)[np.argsort(order)], want)


@pytest.mark.parametrize("scheme, seam", [("dgc", "v"), ("topk", "grad"),
                                          ("fetchsgd", "after")])
def test_inject_incoming_matches_jax(scheme, seam):
    rng = np.random.default_rng(5)
    u, v, g, inc = (rng.normal(size=(3, 7)).astype(np.float32) for _ in range(4))
    jstates = JState(u={"w": jnp.asarray(u)}, v={"w": jnp.asarray(v)}, m={})
    js, jg, jafter = jinject(jresolve(JComp(scheme=scheme)), jstates, {"w": jnp.asarray(g)},
                             {"w": jnp.asarray(inc)})
    tstates = ClientState(u=torch.from_numpy(u), v=torch.from_numpy(v), m={})
    ts, tg, tafter = inject_incoming(resolve(CompressionConfig(scheme=scheme)), tstates,
                                     torch.from_numpy(g), torch.from_numpy(inc))
    assert tafter == jafter == (seam == "after")
    assert np.array_equal(tg.numpy(), np.asarray(jg["w"]))
    assert np.array_equal(ts.v.numpy(), np.asarray(js.v["w"]))
    assert np.array_equal(ts.u.numpy(), u)
    assert inject_incoming(None, tstates, tg, None) == (tstates, tg, False)


# ---------------------------------------------------------------------------
# whole runs against the JAX package
# ---------------------------------------------------------------------------


def _assert_runs_match(j, t):
    for key in ("upload_bytes", "download_bytes", "peer_bytes"):
        assert getattr(t.ledger, key) == getattr(j.ledger, key), key
    assert t.ledger.summary() == j.ledger.summary()
    assert [r["synced"] for r in t.history] == [r["synced"] for r in j.history]
    assert [r["server_ingress_gb"] for r in t.history] == [r["server_ingress_gb"]
                                                           for r in j.history]
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j.params))
    tp = jax.tree_util.tree_leaves(to_jax_params(t.params, layout="transformer"))
    for a, b in zip(jp, tp, strict=True):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


@pytest.mark.parametrize("hops", [1, 3])
@pytest.mark.parametrize("scheme", ["dgcwgmf", "topk"])
def test_ring_matches_jax(hops, scheme):
    kw = dict(ring_hops=hops, sync_every=2)
    j, t = _jax("ring", scheme, **kw), _port("ring", scheme, **kw)
    _assert_runs_match(j, t)
    assert t.ledger.peer_bytes > 0 and not t.history[0]["synced"]


@pytest.mark.parametrize("groups, comp_kw", [(2, None), (4, {"tier_rate": 0.5}),
                                             (2, {"tier_scheme": "dgc"})])
def test_hierarchical_matches_jax(groups, comp_kw):
    j = _jax("hierarchical", "hier_dgcwgmf", comp_kw, groups=groups)
    t = _port("hierarchical", "hier_dgcwgmf", comp_kw, groups=groups)
    _assert_runs_match(j, t)
    jt = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j.engine.tier_cstates))
    tt = [t.layout.unflatten(x) for x in t.engine.tier_cstates if torch.is_tensor(x)]
    tt = jax.tree_util.tree_leaves([to_jax_params(x, layout="transformer") for x in tt])
    for a, b in zip(jt, tt, strict=True):
        assert a.shape == b.shape and np.abs(a - b).max() <= 1e-5 * max(np.abs(a).max(), 1e-30)
    assert t.engine.tier_cstates.v.shape == (groups, t.total_params)


@pytest.mark.parametrize("kw", [dict(scheme="hier_dgcwgmf"), dict(scheme="dgcwgmf"),
                                dict(scheme="dgc", tier_scheme="gmc", tier_rate=0.3,
                                     wire_stage="float16")])
def test_tier_resolves_like_jax(kw):
    jt, tt = jresolve_tier(JComp(**kw)), resolve_tier(CompressionConfig(**kw))
    assert tt.name == jt.name and tt.cfg.rate == jt.cfg.rate and tt.cfg.wire_stage is None
    assert dataclasses.asdict(tt.spec) == dataclasses.asdict(jt.spec)


# ---------------------------------------------------------------------------
# validation: the reference's errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(topology="mesh"), dict(ring_hops=1), dict(groups=2), dict(sync_every=2),
    dict(topology="ring", groups=2), dict(topology="hierarchical", ring_hops=1),
    dict(topology="ring", ring_hops=-1), dict(topology="hierarchical", groups=0),
    dict(topology="ring", sync_every=0), dict(topology="ring", backend="async"),
    dict(topology="hierarchical", backend="async")])
def test_fl_config_knobs_rejected_like_jax(kw):
    with pytest.raises(ValueError) as want:
        JFL(num_clients=4, rounds=1, **kw)
    with pytest.raises(ValueError) as got:
        FLConfig(num_clients=4, rounds=1, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fl_kw, comp_kw", [
    (dict(topology="ring", ring_hops=2), {}),  # 8 clients, segments of 3
    (dict(topology="hierarchical", groups=3), {}),
    (dict(topology="hierarchical", groups=2), dict(tier_scheme="fetchsgd")),
    (dict(topology="ring", ring_hops=1), dict(scheme="adaptive_dgcwgmf")),
    (dict(topology="hierarchical", groups=2), dict(scheme="adaptive_dgcwgmf"))])
def test_engine_rejections_match_jax(fl_kw, comp_kw):
    comp_kw = {"scheme": "hier_dgcwgmf", **comp_kw}
    task = Tiny(8)
    with pytest.raises(ValueError) as want:
        JSim(JFL(**_fl(**fl_kw)), JComp(**comp_kw), task.jax_init, task.jax_loss)
    with pytest.raises(ValueError) as got:
        FLSimulator(FLConfig(**_fl(**fl_kw)), CompressionConfig(**comp_kw), task.torch_init,
                    task.torch_loss, device="cpu")
    assert str(got.value) == str(want.value)


def test_unknown_tier_scheme_rejected_like_jax():
    with pytest.raises(ValueError) as want:
        JComp(scheme="dgc", tier_scheme="nope")
    with pytest.raises(ValueError) as got:
        CompressionConfig(scheme="dgc", tier_scheme="nope")
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]


def test_layouts_match_jax():
    from repro.topo import HierarchicalLayout as JH
    from repro.topo import RingLayout as JR

    for cohort, hops in ((8, 0), (8, 1), (20, 3), (9, 2)):
        a, b = JR(cohort, hops), RingLayout(cohort, hops)
        assert a.segments == b.segments
        for p in range(hops + 1):
            assert np.array_equal(a.position_indices(p), b.position_indices(p))
    for cohort, groups in ((8, 1), (20, 4)):
        assert JH(cohort, groups).group_size == HierarchicalLayout(cohort, groups).group_size
