"""The async, shard, ring and hierarchical engines, and the trainer's gmf
step, on a model of mixed leaf dtypes (``GroupedLayout``: one flat stack
per dtype group), ROADMAP item 15.

Tolerances:
- **degenerate runs against the port's own vmap star run**, on a tiny
  linear-softmax task with a bfloat16 weight beside a float32 bias:
  bitwise params, client and server state, broadcast and (but under the
  hierarchy, whose leaves' uploads are peer bytes) ledger. Async with
  zero delays and a cohort-sized buffer, ring with 0 hops, hierarchical
  with one group and shard at one rank (a one-rank gloo group in
  process), under dgcwgmf, global top-k, adaptive rates (star only),
  FetchSGD, random-k, the probquant wire and the Hadamard rotation (the
  last three not under the hierarchy, whose tier re-sends through the
  wire, and the sketch has no tier).
- **against the JAX package's ``FLSimulator``** (the port fed JAX's client
  gradients, ``tests/torch_train_parity.py``): the tiny task under async
  with stragglers, vmap ring, vmap hierarchical and shard at one rank
  (JAX's vmap), under dgcwgmf, global top-k and adaptive rates, at
  ``check_lmtask``'s bfloat16 tolerances: the state's dtypes the
  reference's, the ledger exact (round by round for the synchronous
  engines), params within 2**-7 of each leaf's largest magnitude (ROADMAP
  R13: the reference's bfloat16 params turn float32 at its first server
  step, the port's stay bfloat16); the async schedule (flushes, pending,
  in flight) exact; the adaptive controller's per-client EMA of the
  signal within rtol 1e-5 (each package sums the squares in its order).
- **the trainer's gmf step** (mesh-less, two gmf_data steps of granite-moe
  at ``smoke()`` in bfloat16) under global top-k (uplink, and the
  downlink), random-k, FetchSGD, the probquant wire, the Hadamard rotation
  and adaptive rates (per tensor and global): it runs, one state stack per
  dtype group (FetchSGD's one sketch-space server state), the params finite
  and moved, the counts within the tree's.
granite-moe at ``smoke()`` in bfloat16 through the async and hierarchical
engines against JAX is in ``tests/test_torch_lmtask_bf16_moe.py``, and the
trainer's gmf step under global top-k and random-k against JAX in
``tests/test_torch_train_step_bf16.py`` (each beside a test that warms the
reference's op caches for that model).
The keyed stages' JAX twins at the stage level are in
``tests/test_torch_mixed_stages.py``; two ranks in
``tests/test_torch_shard.py`` and ``tests/test_torch_tp.py``.
"""

import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_train_parity as tr  # noqa: E402
from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.fl import FLConfig as JFL  # noqa: E402
from repro.fl import FLSimulator as JSim  # noqa: E402
from repro_torch.core import CompressionConfig  # noqa: E402
from repro_torch.fl import FLConfig, FLSimulator  # noqa: E402
from repro_torch.utils.convert import from_jax_params  # noqa: E402
from repro_torch.utils.flat import GroupedLayout  # noqa: E402

D_IN, D_OUT = 12, 4
COMP = dict(rate=0.25, tau=0.4)


class Mixed:
    """Linear-softmax classifier on fixed random data, in both packages: a
    bfloat16 weight and a float32 bias (two dtype groups)."""

    def __init__(self, num_clients=8, samples=16, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(num_clients, samples, D_IN)).astype(np.float32)
        self.y = rng.integers(0, D_OUT, size=(num_clients, samples))
        self.tx, self.ty = torch.from_numpy(self.x), torch.from_numpy(self.y)
        w = jnp.asarray(0.1 * rng.normal(size=(D_IN, D_OUT)), jnp.bfloat16)
        self.jparams = {"b": jnp.zeros((D_OUT,), jnp.float32), "w": w}

    def jax_init(self, key):
        return self.jparams

    def torch_init(self, gen):
        return from_jax_params(jax.tree_util.tree_map(np.asarray, self.jparams),
                               layout="transformer")

    @staticmethod
    def jax_loss(params, batch):
        x, y = batch
        logp = jax.nn.log_softmax(x @ params["w"].astype(jnp.float32) + params["b"], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))

    @staticmethod
    def torch_loss(params, batch):
        x, y = batch
        logp = torch.log_softmax(x @ params["w"].float() + params["b"], dim=-1)
        return -torch.mean(torch.gather(logp, -1, y[..., None]))

    def jax_provider(self):
        return lambda t, ids, rng: (jnp.asarray(self.x[ids]), jnp.asarray(self.y[ids]))

    def torch_provider(self):
        return lambda t, ids, rng: (self.tx[torch.as_tensor(ids)], self.ty[torch.as_tensor(ids)])


def _fl(**kw):
    return {**dict(num_clients=8, rounds=4, clients_per_round=8, batch_size=16,
                   learning_rate=0.5, seed=0), **kw}


def _port(scheme="dgcwgmf", comp_kw=None, group=None, **fl_kw):
    task = Mixed()
    sim = FLSimulator(FLConfig(**_fl(**fl_kw)),
                      CompressionConfig(scheme=scheme, **COMP, **(comp_kw or {})),
                      task.torch_init, task.torch_loss, device="cpu", group=group)
    sim.run(task.torch_provider())
    return sim


def _state(sim):
    out = {f"params/{k}": v for k, v in sim.params.items()}
    for name, x in zip("uvm", sim.cstates, strict=True):
        if isinstance(x, tuple):
            out.update({f"client/{name}/{i}": g for i, g in enumerate(x)})
    for name, x in zip(("momentum", "residual"), sim.sstate, strict=True):
        if isinstance(x, tuple):
            out.update({f"server/{name}/{i}": g for i, g in enumerate(x)})
        elif isinstance(x, dict):
            out.update({f"server/{name}/{k}": g for k, g in x.items()})
    out.update({f"gbar/{i}": g for i, g in enumerate(sim.gbar_prev)})
    return out


# ---------------------------------------------------------------------------
# degenerate runs: the port's own vmap star run, bitwise
# ---------------------------------------------------------------------------

SCHEMES = {
    "dgcwgmf": ("dgcwgmf", None),
    "global": ("dgc", dict(per_tensor=False)),
    "adaptive": ("adaptive_dgcwgmf", dict(per_tensor=False, rate_wire_threshold=0.9)),
    "fetchsgd": ("fetchsgd", dict(sketch_cols=16)),
    "randomk": ("randomk", None),
    "probquant": ("dgc", dict(wire_dtype="probquant")),
    "hadamard": ("dgc", dict(rotation_stage="hadamard", wire_dtype="int8")),
}
ENGINES = {
    "async": dict(backend="async"),
    "ring0": dict(topology="ring", ring_hops=0),
    "hier1": dict(topology="hierarchical", groups=1),
    "shard1": dict(backend="shard"),
}
# (the hierarchy's tier re-sends the group sum through the config's wire, so
# one group is the star only under the float32 wire; a sketch tier is refused)
DEGENERATE = [(e, s) for e in ENGINES for s in SCHEMES
              if not (e in ("ring0", "hier1") and s == "adaptive")
              and not (e == "hier1" and s in ("fetchsgd", "probquant", "hadamard"))]
_STAR: dict = {}


def _star(name):
    if name not in _STAR:
        scheme, comp_kw = SCHEMES[name]
        _STAR[name] = _port(scheme, comp_kw)
    return _STAR[name]


@pytest.mark.parametrize("engine, name", DEGENERATE)
def test_degenerate_engines_are_the_vmap_star_bitwise(tmp_path, engine, name):
    scheme, comp_kw = SCHEMES[name]
    want = _star(name)
    assert isinstance(want.layout, GroupedLayout)
    if engine == "shard1":
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        got = _port(scheme, comp_kw, **ENGINES[engine])
    finally:
        if engine == "shard1":
            dist.destroy_process_group()
    a, b = _state(want), _state(got)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
    if engine != "hier1":  # the hierarchy's leaf payloads are peer bytes
        assert (want.ledger.upload_bytes, want.ledger.download_bytes) == (
            got.ledger.upload_bytes, got.ledger.download_bytes)
    if engine == "async":
        assert got.ledger.staleness_summary()["staleness_hist"] == {0: 4 * 8}


# ---------------------------------------------------------------------------
# the tiny mixed task against the JAX package
# ---------------------------------------------------------------------------

STRAGGLERS = dict(backend="async", delay_model="geometric", delay_mean=1.0, delay_max=4,
                  dropout_rate=0.2, buffer_size=3, rounds=6)
VS_JAX = {
    "async-dgcwgmf": (STRAGGLERS, "async_dgcwgmf", None),
    "async-global": (STRAGGLERS, "dgc", dict(per_tensor=False)),
    "async-adaptive": (STRAGGLERS, "adaptive_dgcwgmf", dict(rate_wire_threshold=0.9)),
    "ring-dgcwgmf": (dict(topology="ring", ring_hops=1, sync_every=2), "dgcwgmf", None),
    "ring-global": (dict(topology="ring", ring_hops=1), "dgc", dict(per_tensor=False)),
    "hier-dgcwgmf": (dict(topology="hierarchical", groups=2), "hier_dgcwgmf", None),
    "hier-global": (dict(topology="hierarchical", groups=2), "dgc", dict(per_tensor=False)),
    "shard-dgcwgmf": (dict(backend="shard"), "dgcwgmf", None),
    "shard-global": (dict(backend="shard"), "dgc", dict(per_tensor=False)),
    "shard-adaptive": (dict(backend="shard"), "adaptive_dgcwgmf",
                       dict(per_tensor=False, rate_wire_threshold=0.9)),
}


def _jax_and_port(monkeypatch, fl_kw, scheme, comp_kw, group=None):
    task = Mixed()
    eager = tr.feed_jax_grads(monkeypatch)
    comp = dict(scheme=scheme, **COMP, **(comp_kw or {}))
    jfl = _fl(**fl_kw)
    if jfl.get("backend") == "shard":  # the port's shard at one rank is JAX's vmap
        jfl["backend"] = "vmap"
    jsim = JSim(JFL(**jfl), JComp(**comp), task.jax_init, task.jax_loss)
    with eager:
        jsim.run(task.jax_provider())
    tsim = FLSimulator(FLConfig(**_fl(**fl_kw)), CompressionConfig(**comp), task.torch_init,
                       task.torch_loss, device="cpu", group=group)
    tsim.run(task.torch_provider())
    return jsim, tsim


def _check_vs_jax(jsim, tsim, sync=True):
    assert tsim.ledger.summary() == jsim.ledger.summary()
    if sync:
        assert [r["comm_gb"] for r in tsim.history] == [r["comm_gb"] for r in jsim.history]
    assert max(tr.leaf_errors(tsim.params, jsim.params, dtypes=False)) <= 2.0 ** -7
    assert tr.flat_dtypes(tsim.params) == ["bfloat16", "float32"]
    for field in ("u", "v", "m"):
        assert tr.flat_dtypes(getattr(tsim.cstates, field)) == tr.jax_dtypes(
            getattr(jsim.cstates, field)), field


@pytest.mark.parametrize("name", list(VS_JAX))
def test_tiny_mixed_task_matches_jax(monkeypatch, tmp_path, name):
    fl_kw, scheme, comp_kw = VS_JAX[name]
    shard = fl_kw.get("backend") == "shard"
    if shard:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        jsim, tsim = _jax_and_port(monkeypatch, fl_kw, scheme, comp_kw)
    finally:
        if shard:
            dist.destroy_process_group()
    asynchronous = fl_kw.get("backend") == "async"
    _check_vs_jax(jsim, tsim, sync=not asynchronous)
    if asynchronous:
        for key in ("applies", "pending", "in_flight", "staleness_mean"):
            assert [r.get(key) for r in tsim.history] == [r.get(key) for r in jsim.history]
        assert any(g > 0 for g in tsim.ledger.staleness_counts)
    if "adaptive" in name:  # the controller saw every sampled client
        assert int(tsim.rate_state.seen.sum()) == int(np.asarray(jsim.rate_state.seen).sum()) > 0
        assert np.allclose(tsim.rate_state.ema.numpy(), np.asarray(jsim.rate_state.ema),
                           rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the trainer's gmf step, mesh-less, under every once-refused stage
# ---------------------------------------------------------------------------

TRAINER_STAGES = {
    "global": dict(scheme="dgc", per_tensor=False),
    "randomk": dict(scheme="randomk"),
    "fetchsgd": dict(scheme="fetchsgd"),
    "probquant": dict(scheme="dgc", wire_stage="probquant"),
    "hadamard": dict(scheme="dgc", rotation_stage="hadamard"),
    "adaptive": dict(scheme="adaptive_dgcwgmf"),
    "adaptive-global": dict(scheme="adaptive_dgcwgmf", per_tensor=False),
    "downlink-global": dict(scheme="dgcwgmf_dl", per_tensor=False),
}


@pytest.fixture(scope="module")
def granite_smoke():
    """granite-moe at ``smoke()`` in bfloat16 (float32 routers: two dtype
    groups), its params from seed 0 and one batch."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_smoke("granite-moe-1b-a400m"), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    b = next(SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=0))
    return cfg, params, {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("name", list(TRAINER_STAGES))
def test_trainer_gmf_step_takes_every_stage_on_a_mixed_tree(granite_smoke, name):
    """Two gmf_data steps of the one-device trainer on granite-moe's mixed
    tree under each stage that works across leaves or keys draws by leaf:
    one state stack per dtype group (FetchSGD: none, its server state one
    sketch), every param finite and some moved, the counts positive and
    at most the whole tree's (the rotation's: its padded leaves)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist import step as dstep
    from repro_torch.utils import tree_leaves

    cfg, params, batch = granite_smoke
    tcfg = TrainConfig(learning_rate=0.05, total_steps=4, grad_sync="gmf_data")
    ccfg = CompressionConfig(rate=0.1, **TRAINER_STAGES[name])
    state = dstep.init_train_state(cfg, tcfg, ccfg, params)
    step = dstep.make_train_step(cfg, tcfg, ccfg)
    for _ in range(2):
        state, met = step(state, batch)
    total = int(met["total_params"])
    sketch = name == "fetchsgd"
    assert isinstance(state.cstate.v, dict if sketch else tuple)
    if sketch:
        assert set(state.sstate.momentum) == {"s_mom", "s_err"}
    assert isinstance(state.gbar, tuple) or not state.gbar
    leaves = tree_leaves(state.params)
    assert all(bool(torch.isfinite(x.float()).all()) for x in leaves)
    assert any(not torch.equal(a, b) for a, b in zip(leaves, tree_leaves(params), strict=True))
    up, down = int(met["upload_nnz"].sum()), int(met["download_nnz"])
    assert up > 0 and down > 0 and down <= total
    assert up <= total or name == "hadamard"
