"""The port's steps over a mesh (``repro_torch.dist.step`` with a
``DeviceMesh``) against the JAX package's ``make_train_step`` / prefill /
decode at the same meshes.

One rank, in process (a gloo world of one rank from a ``file://`` store,
and JAX's real (1, 1) mesh on its one CPU device):
- ``gmf_data`` fed JAX's gradient (``tests/torch_train_parity.py``), with
  ``tests/test_torch_train_step_gmf.py``'s tolerances: the params, the
  compression state and the broadcast within 1e-5 of each leaf's largest
  magnitude but at FLIPS boundary flips, the counts within as many;
- the mesh steps at (1, 1) / (1, 1, 1) bitwise the mesh-less ones
  (``gmf_pod`` bitwise ``gmf_data``);
- ``dense`` on a granite smoke with ``moe_impl="ep"`` (each side its own
  gradient, through the expert-parallel MoE): params within 1e-5;
- prefill and decode of that config with a mesh: logits and caches within
  1e-5 (``tests/torch_parity.py``), greedy tokens equal.

Four ranks, spawned (one gloo world of four processes, ``torch.set_num_threads
(1)``, every check of the module in one spawn, and at the same time the
JAX package on four faked devices; ``tests/torch_mesh_*.py``): two steps of
``gmf_data`` and ``dense`` at (4, 1), ``gmf_pod`` at (2, 2, 1) on llama
and on a ``moe_impl="dense"`` granite (the pod's router density), and
``dense`` on the ``moe_impl="ep"`` granite at (4, 1), on batches whose -1
labels fall unevenly across the ranks (15 valid labels on rank 0, 32 on
the others). Meshes smaller than the world run on its first ranks, the
others sitting out (ROADMAP F6): ``gmf_data`` at (2, 1) and ``dense`` at
(1, 1), with JAX's meshes on the first devices, and a client mesh of 2.
Tensor parallelism at a model axis of 2 (ROADMAP item 11 part C1):
``gmf_data`` at (2, 2) and ``gmf_pod`` at (2, 1, 2) on llama, ``dense``
on yi-34b at (2, 2) (its q and kv cuts fall mid-head) and ``gmf_data`` on
a ``moe_impl="dense"`` granite at (2, 2) (experts cut, its vocabulary of
515 whole); the params and compression rows are gathered whole for the
comparison. Tolerances per shard, as at n = 1 (each side its own
gradients): every leaf of the params, of each shard's compression state
and of the broadcast within 1e-5 of its largest magnitude but at FLIPS
flips a shard, the counts within as many, the loss within 1e-5. Replicated
state (params, opt slots, broadcast, loss) is bitwise equal on every rank
of a mesh, and so are a pod's data ranks' rows and a model group's. A
checkpoint restored onto (4, 1) under FSDP's specs gives each rank its
slice and gathers back bitwise.
FSDP over ``data`` (ROADMAP item 11 part C2a; the smoke configs fall under
the 40e9 threshold, so both sides set ``_FSDP_PARAM_THRESHOLD`` to 0 for
these cases only): ``dense`` on qwen2-vl at (2, 2) (its batches carry
patch embeddings), ``gmf_data`` on command-r at (2, 2) (each data rank's
client state whole over data), ``gmf_pod`` on llama at (1, 2, 2) (the
pod's rows cut over its data x model ranks) and (2, 2, 1), and ``dense`` on
a ``moe_impl="ep"`` kimi-k2 at (2, 2): FSDP, tensor parallelism and the
expert-parallel MoE together; and the expert-parallel MoE at model 2
without FSDP (granite, ``dense``). The params, rows and broadcast are
gathered whole for the comparison. The trainer's health norms (ROADMAP F7)
over ``gmf_data`` at (2, 2) and the FSDP gmf cases equal the reference's
norms of the whole state within 1e-6 relative; the data-axis-only sums
they replaced do not.

The compression stages that cut or key a leaf by flat coordinate over the
model axis (ROADMAP item 11 part C2b; ``cases.SCHEMES``): ``gmf_data`` on
llama at (2, 2) under sampled dgcwgmf, dgc's global top-k, dgc with the
int8 wire, fetchsgd and adaptive_dgcwgmf (at its nominal rate: the mesh
step threads no rates), and the int8 wire under ``gmf_pod`` FSDP at (1, 2,
2), with the same tolerances but two: the JAX witness of the sampled case
runs at (2, 1) (``cases.JAX_SHAPE``: its (2, 2) program's gradient noise
moves one entry across a sample point's score, which the second step then
carries everywhere; JAX computes the same function at any mesh), and the
int8 cases allow ``cases.WIRE_FLIPS`` rounding flips a shard (an entry
within the gradient noise of a half step rounds to the next step).

The launcher runs apart: ``launch/train.py --device cpu --mesh-shape 2,1``
as two processes with a ``torchrun``-style environment (``MASTER_ADDR``
127.0.0.1 and a free ``MASTER_PORT``): both exit 0 and only rank 0 writes.
Then three worlds of four processes at once: ``--mesh-shape 2,2``, no
``--mesh-shape`` (the reference's (n // 2, 2)) and ``--mesh-shape 2,1``
(ranks 2 and 3 wait for the mesh's result): every rank exits 0. Beside
them, ``launch/serve.py --mode engine --mesh-shape 1,2`` as two processes:
the engine over a model axis, rank 0's tokens those of one process.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
import torch_parity as tp_  # noqa: E402
import torch_train_parity as tr  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.configs import granite_moe_1b_a400m as jgranite  # noqa: E402
from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import restore as trestore  # noqa: E402
from repro_torch.checkpoint import save as tsave  # noqa: E402
from repro_torch.configs import granite_moe_1b_a400m as tgranite  # noqa: E402
from repro_torch.core import CompressionConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMStream  # noqa: E402
from repro_torch.dist import sharding as tshr  # noqa: E402
from repro_torch.dist import step as tstep  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_mesh  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FLIPS = 4
REL = 1e-5


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def meshes(shape):
    axes = cases.axes_of(shape)
    return jmake_mesh(shape, axes), make_mesh(shape, axes, "cpu")


# ---------------------------------------------------------------------------
# one rank, in process
# ---------------------------------------------------------------------------


def test_one_rank_gmf_data_on_jax_gradients(one_rank, monkeypatch):
    jst, tst, ((jm, tm),) = tr.one_step("llama3.2-1b", "gmf_data", jax_grads=monkeypatch,
                                        meshes=meshes((1, 1)))
    up = abs(int(tm["upload_nnz"][0]) - int(np.asarray(jm["upload_nnz"])[0]))
    down = abs(int(tm["download_nnz"]) - int(jm["download_nnz"]))
    assert up <= FLIPS and down <= FLIPS, (up, down)
    flips = tr.boundary_flips(tst.params, jst.params)
    layout = tr.FlatLayout.of(tst.params)
    for field in ("u", "v", "m"):
        flips = max(flips, tr.boundary_flips(layout.unflatten(getattr(tst.cstate, field)),
                                             getattr(jst.cstate, field)))
    flips = max(flips, tr.boundary_flips(layout.unflatten(tst.gbar), jst.gbar))
    assert flips <= FLIPS, flips


def run_port(cfg, sync, mesh, steps=2):
    tcfg = tr.TTrain(learning_rate=0.05, total_steps=10, grad_sync=sync, lr_schedule="cosine",
                     warmup_steps=1)
    ccfg = CompressionConfig(scheme="dgcwgmf", rate=0.1)
    state = tstep.init_train_state(cfg, tcfg, ccfg,
                                   ttr.init_params(cfg, torch.Generator().manual_seed(0)), mesh)
    fn = tstep.make_train_step(cfg, tcfg, ccfg, mesh)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4, seed=0)
    out = []
    for _, b in zip(range(steps), stream, strict=False):
        state, m = fn(state, {k: torch.from_numpy(v).long() for k, v in b.items()})
        out.append(m)
    return [state, out]


def bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb, strict=True):
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), (x, y)


@pytest.mark.parametrize("sync, shape, twin", [
    ("gmf_data", (1, 1), "gmf_data"), ("dense", (1, 1), "dense"),
    ("gmf_pod", (1, 1, 1), "gmf_data")])
def test_one_rank_mesh_steps_are_the_meshless_steps_bitwise(one_rank, sync, shape, twin):
    """On one CPU thread: with several, the CPU's backward is not bitwise
    repeatable from run to run, mesh or none (the card's is)."""
    cfg = tconfigs.get_smoke("llama3.2-1b")
    mesh = make_mesh(shape, cases.axes_of(shape), "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bitwise(run_port(cfg, sync, mesh), run_port(cfg, twin, None))
    finally:
        torch.set_num_threads(threads)


def test_one_rank_dense_ep_against_jax(one_rank):
    """The dense step through the expert-parallel MoE at (1, 1): each
    package its own gradient; params and loss within 1e-5."""
    jcfg, tcfg = tp_.configs(jgranite, tgranite, "float32", moe_impl="ep")
    jp, tp = tp_.params(jcfg)
    jm, tm = meshes((1, 1))
    jt, tt = tr.train_configs("dense")
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.dist import sharding as jshr
    from repro.dist import step as jstep

    jb, tb = tp_.prompts(jcfg, 4, 16, seed=3)
    labels = np.roll(np.asarray(jb["tokens"]), -1, axis=1)
    labels[0, :9] = -1
    jb["labels"], tb["labels"] = jax.numpy.asarray(labels), torch.from_numpy(labels).long()
    jst = jstep.init_train_state(jcfg, jt, JComp(), jp, jm)
    jst, jmet = jax.jit(jstep.make_train_step(jcfg, jt, JComp(), jm))(
        jst, jax.device_put(jb, jax.tree_util.tree_map(
            lambda s: NamedSharding(jm, s), jshr.train_batch_specs(jcfg, jm),
            is_leaf=lambda x: isinstance(x, PartitionSpec))))
    tst = tstep.init_train_state(tcfg, tt, CompressionConfig(), tp, tm)
    calls = []
    real = ttr.moe.moe_ep
    ttr.moe.moe_ep = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        tst, tmet = tstep.make_train_step(tcfg, tt, CompressionConfig(), tm)(tst, tb)
    finally:
        ttr.moe.moe_ep = real
    assert len(calls) == tcfg.num_layers
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= REL * abs(float(jmet["loss"]))
    assert max(tr.leaf_errors(tst.params, jst.params)) <= REL


def test_one_rank_prefill_and_decode_with_a_mesh(one_rank):
    jcfg, tcfg = tp_.configs(jgranite, tgranite, "float32", moe_impl="ep")
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 2, 20, seed=1)
    tp_.check_prefill_decode(jcfg, tcfg, jp, tp, jb, tb, "float32", prompt_len=20, gen=4,
                             cache_len=24, meshes=meshes((1, 1)))


def test_one_rank_engine_with_a_mesh(one_rank):
    """``ServeEngine(..., mesh=...)`` at (1, 1): the pool laid out by
    ``pool_specs`` (the whole pool), the tokens the mesh-less engine's; an
    EP config's admissions and ticks run ``moe_ep``."""
    from repro_torch.serve import ServeConfig, ServeEngine

    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    scfg = ServeConfig(page_size=8, pages_per_slot=4, prompt_pad=16, max_new_tokens=4)
    prompts = [np.arange(3 + i, dtype=np.int32) % 50 for i in range(3)]
    for cfg in (tconfigs.get_smoke("llama3.2-1b"),
                dataclasses.replace(tconfigs.get_smoke("granite-moe-1b-a400m"), moe_impl="ep",
                                    capacity_factor=8.0)):
        params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
        runs = []
        for m in (None, mesh):
            eng = ServeEngine(cfg, params, scfg, mesh=m)
            for p in prompts:
                eng.submit(p)
            runs.append([c.tokens.tolist() for c in eng.run()[0]])
        assert runs[0] == runs[1], cfg.name


# ---------------------------------------------------------------------------
# four ranks, spawned
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    import torch_mesh_ranks as ranks

    work = tmp_path_factory.mktemp("world4")
    inputs = {}
    for arch in cases.ARCHS:
        cfg = tconfigs.get_smoke(arch)
        params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
        for i, x in enumerate(tree_leaves(params)):
            inputs[f"params/{arch}/{i}"] = x.numpy()
        if arch == cases.ARCHS[0]:
            tsave(str(work / "ck"), params, step=1)
        stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=cases.SEQ,
                                   batch_size=cases.BATCH, seed=0, num_patches=cfg.num_patches,
                                   d_model=cfg.d_model)
        for t, b in zip(range(cases.STEPS), stream, strict=False):
            for k, x in b.items():
                inputs[f"batch/{arch}/{t}/{k}"] = x
            inputs[f"batch/{arch}/{t}/labels"] = cases.uneven_labels(b["labels"])
    np.savez(work / "inputs.npz", **inputs)
    jres, rres = ranks.spawn("train", work, work / "inputs.npz")
    return jres, rres, inputs


def within(got, want, rel=REL):
    """(max relative error, entries past ``rel`` of the largest |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    return np.abs(got - want).max() / scale, int((np.abs(got - want) > rel * scale).sum())


def owners(shape, sync):
    """(shards, the first rank of each shard's row)."""
    axis = "data" if sync == "gmf_data" else "pod"
    n = shape[cases.axes_of(shape).index(axis)]
    return n, [c * (cases.members(shape) // n) for c in range(n)]


@pytest.mark.parametrize("name", list(cases.TRAIN))
def test_four_ranks_agree_with_jax(world4, name):
    jres, rres, _ = world4
    _, _, shape, sync = cases.TRAIN[name]
    flips_ = cases.WIRE_FLIPS.get(name, FLIPS)
    r0 = rres[0]
    # JAX's mesh takes the first devices, the port's the first ranks
    assert jres[f"{name}/devices"].tolist() == list(range(cases.members(
        cases.JAX_SHAPE.get(name, shape))))
    n_leaves = len([k for k in r0 if k.startswith(f"{name}/params/")])
    assert n_leaves > 0
    flips = sum(within(r0[f"{name}/params/{i}"], jres[f"{name}/params/{i}"])[1]
                for i in range(n_leaves))
    n = 1
    if sync != "dense":
        n, first = owners(shape, sync)
        fields = [f for f in ("u", "v", "m", "gbar") if f"{name}/{f}" in jres]
        assert fields == [f for f in ("u", "v", "m", "gbar") if f"{name}/{f}" in r0]
        for f in fields[:-1] if "gbar" in fields else fields:
            got = np.concatenate([rres[r][f"{name}/{f}"] for r in first])
            flips = max(flips, within(got, jres[f"{name}/{f}"])[1])
        if "gbar" in fields:
            flips = max(flips, within(r0[f"{name}/gbar"], jres[f"{name}/gbar"])[1])
        for t in range(cases.STEPS):
            up = np.abs(r0[f"{name}/upload_nnz/{t}"].astype(np.int64)
                        - jres[f"{name}/upload_nnz/{t}"].astype(np.int64))
            assert r0[f"{name}/upload_nnz/{t}"].shape == (n,)
            assert up.max() <= FLIPS, (name, t, up)
            assert abs(int(r0[f"{name}/download_nnz/{t}"])
                       - int(jres[f"{name}/download_nnz/{t}"])) <= FLIPS * n
    assert flips <= flips_ * n, (name, flips)
    for t in range(cases.STEPS):
        got, want = float(r0[f"{name}/loss/{t}"]), float(jres[f"{name}/loss/{t}"])
        assert abs(got - want) <= REL * abs(want), (name, t, got, want)


@pytest.mark.parametrize("name", list(cases.TRAIN))
def test_four_ranks_replicated_state_is_bitwise(world4, name):
    """Every rank of the mesh holds the same whole params (the replicated
    leaves bitwise, the cut ones gathered), broadcast, loss and counts; the
    ranks past the mesh hold nothing of it."""
    _, rres, _ = world4
    _, _, shape, sync = cases.TRAIN[name]
    keys = [k for k in rres[0] if k.startswith(f"{name}/") and
            any(k.startswith(f"{name}/{f}") for f in ("params/", "opt/", "gbar", "loss/",
                                                       "upload_nnz/", "download_nnz/"))]
    assert keys
    inside = cases.members(shape)
    for r in range(1, inside):
        for k in keys:
            assert np.array_equal(rres[r][k], rres[0][k]), (name, r, k)
    for r in range(inside, cases.WORLD):
        assert not any(k.startswith(f"{name}/") for k in rres[r]), (name, r)
    if sync == "dense":
        return
    n, first = owners(shape, sync)
    fields = [f for f in ("u", "v", "m") if f"{name}/{f}" in rres[0]]
    for c, r0 in enumerate(first):  # a shard's ranks (a pod's data ranks, a model
        for r in range(r0, r0 + inside // n):  # group) hold one row
            for f in fields:
                assert np.array_equal(rres[r][f"{name}/{f}"], rres[r0][f"{name}/{f}"]), (c, r)
    if sync == "gmf_data" and n > 1 and "v" in fields:  # each data shard is its own client
        assert not np.array_equal(rres[first[0]][f"{name}/v"], rres[first[1]][f"{name}/v"])


def _jax_tree(row, arch, cfg):
    """A flat ``[n, N]`` row stack (or an ``[N]`` vector) of ``arch``'s
    whole leaves as the JAX package's tree of ``[n, *shape]`` leaves."""
    from repro.models import transformer as jtr

    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **cfg)
    like = jax.eval_shape(lambda: jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    leaves, lead, start = [], row.shape[:-1], 0
    for x in jax.tree_util.tree_leaves(like):
        n = int(np.prod(x.shape))
        leaves.append(jax.numpy.asarray(row[..., start:start + n].reshape(*lead, *x.shape)))
        start += n
    assert start == row.shape[-1]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)


@pytest.mark.parametrize("name", cases.HEALTH)
def test_four_ranks_health_norms_are_the_whole_models(world4, name):
    """ROADMAP F7: the trainer's ``--obs`` health norms over a mesh are the
    reference's (``repro.obs.health.compensation_norms`` of its global
    arrays: here of the port's state gathered whole), within 1e-6
    relative, on every rank, and ``broadcast_finite`` is False on every
    rank when one rank's piece of the broadcast holds a NaN; the sums they
    replaced (the client norms' squares over the sync axis alone, the
    broadcast's the rank's pieces') were not."""
    from repro.core.state import ClientState, ServerState
    from repro.obs import health as jhealth

    _, rres, _ = world4
    arch, over, shape, sync = cases.TRAIN[name]
    n, first = owners(shape, sync)
    rows = {f: np.concatenate([rres[r][f"{name}/{f}"] for r in first]) for f in ("u", "v", "m")}
    cstate = ClientState(**{f: _jax_tree(rows[f], arch, over) for f in rows})
    want = jhealth.compensation_norms(cstate, ServerState(momentum={}, residual={}),
                                      _jax_tree(rres[0][f"{name}/gbar"], arch, over))
    keys = ("residual_u_norm", "residual_v_norm", "momentum_m_norm", "server_momentum_norm",
            "broadcast_norm")
    want = np.asarray([want[k] for k in keys])
    assert (want[[0, 1, 2, 4]] > 0).all()
    for r in range(cases.members(shape)):
        got = rres[r][f"{name}/health/new"]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (r, got, want)
        # a NaN planted on rank 1's piece of the broadcast trips every rank
        assert rres[r][f"{name}/health/finite"].tolist() == [True, False], r
    old = rres[0][f"{name}/health/old"]
    assert np.abs(old - want).max() > 1e-3 * np.abs(want).max(), (old, want)


_TALLY: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _tally_spawn(tmp_path_factory):
    """Start the fake-tensor pass of each ``cases.TALLY`` case's first step
    (``tests/torch_dryrun_passes.py --tally``) with the module: it runs
    while the ranks do."""
    from repro_torch.launch import dryrun

    out = tmp_path_factory.mktemp("tally") / "tally.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **dryrun.tracer_env())
    _TALLY["out"] = out
    script = str(ROOT / "tests" / "torch_dryrun_passes.py")
    _TALLY["proc"] = subprocess.Popen([sys.executable, script, "--tally", str(out)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield
    if _TALLY["proc"].poll() is None:
        _TALLY["proc"].kill()
        _TALLY["proc"].wait()


@pytest.fixture(scope="module")
def fake_tally():
    """The fake pass's collective tally of each ``cases.TALLY`` case."""
    proc = _TALLY["proc"]
    log = proc.communicate(timeout=300)[0]
    assert proc.returncode == 0, log[-6000:]
    return json.loads(Path(_TALLY["out"]).read_text())


@pytest.mark.parametrize("name", cases.TALLY)
def test_four_ranks_tally_equals_the_fake_pass(world4, fake_tally, name):
    """``obs.collectives.CollectiveTally`` of a real first step over gloo at
    (2, 2) on every rank: kind by kind, in counts and result bytes, the
    fake-tensor pass's of the same configuration on rank 0 of a fake world
    of four (the CPU's path: the plain versions' collectives)."""
    _, rres, _ = world4
    want = fake_tally[name]
    for r in range(cases.WORLD):
        got = json.loads(str(rres[r][f"{name}/tally"]))
        assert got == want, (name, r, got, want)
    assert want["counts"].get("all-reduce", 0) > 0


@pytest.mark.parametrize("name", cases.PLACES)
def test_four_ranks_static_places_equal_the_collectives(world4, name):
    """The owner flags, shared flags and every rank's boxes that the step's
    row layouts take from the specs on the host are what the ranks' old
    collectives (the not-owner flags all-reduced, the boxes and owner flags
    all-gathered over the row's group) give."""
    _, rres, _ = world4
    for r in range(cases.WORLD):
        assert rres[r][f"{name}/places"].item() is True, (name, r)


def test_four_ranks_client_mesh_of_two(world4):
    """``make_client_mesh(2)`` in a world of 4 holds ranks 0 and 1, as the
    reference's holds devices 0 and 1; the others sit out (ROADMAP F6)."""
    jres, rres, _ = world4
    assert jres["client_mesh/devices"].tolist() == [0, 1]
    for r in range(cases.WORLD):
        if r < cases.CLIENT_MESH:
            assert rres[r]["client_mesh/coord"].tolist() == [r]
            assert rres[r]["client_mesh/sum"].tolist() == [3.0]
        else:
            assert "client_mesh/coord" not in rres[r]


def test_four_ranks_uneven_labels(world4):
    """The batches' -1 labels fall unevenly (rank 0 holds 15 valid labels,
    the others 32), so a mean of the ranks' means is another number than
    the reference's loss over the global (dense) or pod (gmf_pod) count,
    which the four-rank loss matches (``test_four_ranks_agree_with_jax``)."""
    _, rres, inputs = world4
    valid = [int(rres[r]["dense/valid/0"]) for r in range(cases.WORLD)]
    assert valid == [15, 32, 32, 32]
    labels = inputs[f"batch/{cases.ARCHS[0]}/0/labels"]
    assert int((labels >= 0).sum()) == sum(valid)


def test_four_ranks_restore_onto_a_mesh(world4):
    """``restore(..., shardings=...)`` onto (4, 1) under FSDP's specs: each
    rank's leaf is its data-axis slice of the saved one, and the pieces
    gather back to the whole tree, bitwise."""
    _, rres, inputs = world4
    arch = cases.ARCHS[0]
    cfg = tconfigs.get_smoke(arch)
    like = ttr.abstract_params(cfg)
    specs = tree_leaves(tshr.param_specs(like, fsdp=True, mesh=AbstractMesh((4, 1), (
        "data", "model"))))
    assert any("data" in tuple(s) for s in specs)
    for i, spec in enumerate(specs):
        whole = inputs[f"params/{arch}/{i}"]
        for r in range(cases.WORLD):
            assert np.array_equal(rres[r][f"restore/full/{i}"], whole), (i, r)
            want = whole
            if "data" in tuple(spec):
                d = tuple(spec).index("data")
                want = np.split(whole, cases.WORLD, axis=d)[r]
            assert np.array_equal(rres[r][f"restore/local/{i}"], want), (i, r)


def test_four_ranks_restore_at_model_two(world4):
    """``restore(..., shardings=...)`` onto (2, 2) under the tensor-parallel
    specs: each rank's leaf is its model-axis slice of the saved one (rank r
    at model coordinate r % 2), whole where the spec names no axis."""
    _, rres, inputs = world4
    arch = cases.ARCHS[0]
    like = ttr.abstract_params(tconfigs.get_smoke(arch))
    specs = tree_leaves(tshr.param_specs(like, fsdp=False, mesh=AbstractMesh((2, 2), (
        "data", "model"))))
    assert any("model" in tuple(s) for s in specs)
    for i, spec in enumerate(specs):
        whole = inputs[f"params/{arch}/{i}"]
        for r in range(cases.WORLD):
            want = whole
            if "model" in tuple(spec):
                want = np.split(whole, 2, axis=tuple(spec).index("model"))[r % 2]
            assert np.array_equal(rres[r][f"restore22/local/{i}"], want), (i, r)


# ---------------------------------------------------------------------------
# the launcher over two ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_over_two_ranks(tmp_path):
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--mesh-shape", "2,1",
            "--grad-sync", "gmf_data", "--steps", "8", "--batch", "8", "--seq-len", "64",
            "--log-every", "4", "--metrics-out", "m.json", "--checkpoint", "ck", "--obs",
            "--obs-dir", "obs"]
    port = str(free_port())
    procs = []
    for r in range(2):
        cwd = tmp_path / f"r{r}"
        cwd.mkdir()
        env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
               "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}
        procs.append(subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args],
                                      env=env, cwd=cwd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    logs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            logs.append(out)
            errs = err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs) + errs[-3000:]
    assert "mesh={'data': 2, 'model': 1}" in logs[0] and "(improved)" in logs[0]
    assert logs[1].strip() == ""  # rank 1 prints nothing
    assert sorted(os.listdir(tmp_path / "r1")) == []
    assert {"m.json", "ck.npz", "ck.meta", "obs"} <= set(os.listdir(tmp_path / "r0"))
    history = json.loads((tmp_path / "r0" / "m.json").read_text())
    assert len(history) == 8 and len(history[0]["upload_nnz"]) == 2
    events = [json.loads(ln) for ln in (tmp_path / "r0" / "obs" / "events.jsonl").read_text()
              .splitlines()]
    health = [e["data"] for e in events if e["kind"] == "health"]
    assert len(health) == 8 and all(e["residual_u_norm"] > 0 for e in health)


# world name -> the --mesh-shape flags and the mesh rank 0 prints
WORLDS4 = {"2x2": (["--mesh-shape", "2,2", "--checkpoint", "ck"],
                   "mesh={'data': 2, 'model': 2}"),
           "default": ([], "mesh={'data': 2, 'model': 2}"),
           "2x1": (["--mesh-shape", "2,1"], "mesh={'data': 2, 'model': 1}")}


# the serving engine over a model axis: two launcher processes at (1, 2)
SERVE_ENGINE = ["-m", "repro_torch.launch.serve", "--arch", "llama3.2-1b", "--smoke", "--device",
                "cpu", "--mode", "engine", "--requests", "4", "--prompt-len", "32", "--gen", "6",
                "--wire", "int8"]


@pytest.fixture(scope="module")
def launched4(tmp_path_factory):
    """The three worlds of four launcher processes and the serving world of
    two (``SERVE_ENGINE`` at ``--mesh-shape 1,2``), all started at once."""
    base = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--grad-sync", "gmf_data",
            "--steps", "8", "--batch", "8", "--seq-len", "64", "--log-every", "4"]
    procs, works = {}, {}
    worlds = {name: (["-m", "repro_torch.launch.train", *base, *flags], 4)
              for name, (flags, _) in WORLDS4.items()}
    worlds["serve"] = ([*SERVE_ENGINE, "--mesh-shape", "1,2"], 2)
    for name, (argv, world) in worlds.items():
        port = str(free_port())
        work = works[name] = tmp_path_factory.mktemp(f"launch_{name}")
        procs[name] = [subprocess.Popen(
            [sys.executable, *argv],
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                 "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port},
            cwd=work, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    out = {}
    try:
        for name, ps in procs.items():
            out[name] = ([(p.communicate(timeout=240)[0], p.returncode) for p in ps],
                         works[name])
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


@pytest.mark.parametrize("name", list(WORLDS4))
def test_launcher_over_four_ranks(launched4, name):
    """Every rank of the world exits 0 (rank 0's code); rank 0 trains over
    the mesh it prints, the loss improving."""
    runs, work = launched4[name]
    assert [rc for _, rc in runs] == [0] * 4, "\n".join(log[-2000:] for log, _ in runs)
    assert WORLDS4[name][1] in runs[0][0] and "(improved)" in runs[0][0], runs[0][0][-2000:]
    if "--checkpoint" in WORLDS4[name][0]:  # saved at model 2: the whole params, gathered
        like = ttr.abstract_params(tconfigs.get_smoke("llama3.2-1b"))
        back = trestore(str(work / "ck"), like)
        assert [tuple(x.shape) for x in tree_leaves(back)] == [
            tuple(x.shape) for x in tree_leaves(like)]


def test_serve_engine_over_a_model_axis(launched4):
    """``launch/serve.py --mode engine --mesh-shape 1,2`` over two
    torchrun-style processes (ROADMAP item 11 part C2a): both exit 0, rank
    0 prints the reference's summary and the same tokens as one process
    without a world; rank 1 prints nothing."""
    runs, _ = launched4["serve"]
    assert [rc for _, rc in runs] == [0, 0], "\n".join(log[-2000:] for log, _ in runs)
    one = subprocess.run([sys.executable, *SERVE_ENGINE], env={
        "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-2000:]

    def tokens(log):
        return [ln for ln in log.splitlines() if ln.lstrip().startswith("req ")]

    assert tokens(runs[0][0]) == tokens(one.stdout) and tokens(one.stdout)
    summary = json.loads(runs[0][0].strip().splitlines()[-1])
    assert summary["mode"] == "engine" and summary["generated_tokens"] == 24
    assert not [ln for ln in runs[1][0].splitlines() if ln.strip() and "[W" not in ln
                and "socket" not in ln]
