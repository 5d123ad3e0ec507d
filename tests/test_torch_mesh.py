"""The port's meshes (``repro_torch.launch.mesh``) and partition specs
(``repro_torch.dist.sharding``) against the JAX package's.

Spec parity runs in process, with no world: the JAX side takes
``jax.eval_shape`` params (and caches and pools) under
``jax.sharding.AbstractMesh``, the port side meta-device ones
(``transformer.abstract_params``) under its ``AbstractMesh``, for all ten
architectures at their published shapes and six meshes, (1, 1) to the
production (2, 16, 16). Every spec is equal entry for entry (``tuple(P)``),
but the flat compression stacks: the port's ``[n, N]`` stack is ``P(axis)``,
and each of the reference's per-leaf stacked specs must lead with that
axis and name, past it, only axes of size 1 on a mesh whose model axis is
1 (but FSDP's data axis for the >40 B archs). The port's steps take a
model axis > 1 (each rank's row holds its pieces of the leaves) and FSDP
over a data axis > 1 (ROADMAP item 11 part C2a): the specs hold where FSDP
is on, and which leaves the forward gathers over ``data``.

The meshes themselves are built in a one-rank gloo world (``file://``
store in the test's temporary directory, no port opened), where the FL
shard engine also takes a client mesh's group.
"""

import dataclasses
import datetime
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.dist import sharding as jshr  # noqa: E402
from repro.dist import step as jstep  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import TrainConfig as TTrain  # noqa: E402
from repro_torch.core import CompressionConfig as TComp  # noqa: E402
from repro_torch.dist import sharding as tshr  # noqa: E402
from repro_torch.dist import step as tstep  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

MESHES = [(1, 1), (4, 1), (4, 2), (2, 2, 1), (16, 16), (2, 16, 16)]
META = torch.device("meta")


def axes_of(shape):
    return ("pod", "data", "model")[-len(shape):]


@functools.lru_cache(maxsize=None)
def shapes(arch):
    """(JAX params, port params, JAX cache, port cache) at full size, as
    shapes only."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jp = jax.eval_shape(lambda: jtr.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = ttr.abstract_params(tcfg)
    jc = jax.eval_shape(lambda: jtr.init_cache(jcfg, 8, 64))
    tc = ttr.init_cache(tcfg, 8, 64, device=META)
    return jp, tp, jc, tc


def j_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def assert_same_specs(port, ref, what):
    got, want = tree_leaves(port), j_leaves(ref)
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert isinstance(g, tshr.P), (what, i, g)
        assert tuple(g) == tuple(w), (what, i, g, w)


def assert_same_shapes(port, ref):
    got, want = tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", list(tconfigs.ARCH_IDS))
def test_specs_equal_the_reference(arch, shape):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jp, tp, jc, tc = shapes(arch)
    assert_same_shapes(tp, jp)
    assert_same_shapes(tc, jc)
    jm, tm = JMesh(shape, axes_of(shape)), tmesh.AbstractMesh(shape, axes_of(shape))
    assert tmesh.mesh_axes(tm) == tuple(jm.axis_names)
    assert tmesh.has_pod_axis(tm) == ("pod" in jm.axis_names)
    assert tshr.dp_axes(tm) == jshr.dp_axes(jm)
    for fsdp in (False, True):
        assert_same_specs(tshr.param_specs(tp, fsdp=fsdp, mesh=tm),
                          jshr.param_specs(jp, fsdp=fsdp, mesh=jm), ("params", fsdp))
    assert_same_specs(tshr.train_batch_specs(tcfg, tm), jshr.train_batch_specs(jcfg, jm), "batch")
    for gb in (None, 1, 16):
        assert_same_specs(tshr.decode_batch_specs(tcfg, tm, gb),
                          jshr.decode_batch_specs(jcfg, jm, gb), ("decode", gb))
    assert tuple(tshr.kv_entry_spec(tcfg, tm)) == tuple(jshr.kv_entry_spec(jcfg, jm))
    assert tuple(tshr.kv_page_spec(tcfg, tm)) == tuple(jshr.kv_page_spec(jcfg, jm))
    assert_same_specs(tshr.cache_specs_from(tc, tm), jshr.cache_specs_from(jc, jm), "cache")
    try:
        jpool = jax.eval_shape(lambda: jcache.init_pool(
            jcfg, jcache.make_kv_codec("int8", jcfg), 9, 16))
    except ValueError as e:  # a family without a KV pool: the port refuses it too
        with pytest.raises(ValueError, match=str(e)[:40]):
            tcache.init_pool(tcfg, tcache.make_kv_codec("int8", tcfg), 9, 16, device=META)
    else:
        tpool = tcache.init_pool(tcfg, tcache.make_kv_codec("int8", tcfg), 9, 16, device=META)
        assert_same_shapes(tpool, jpool)
        assert_same_specs(tshr.pool_specs(tpool, tm), jshr.pool_specs(jpool, jm), "pool")
    # the train state's specs, under each sync mode the mesh has
    for sync in ("dense", "gmf_pod" if len(shape) == 3 else "gmf_data"):
        jt = JTrain(grad_sync=sync, momentum=0.9)
        tt = TTrain(grad_sync=sync, momentum=0.9)
        jspec = jstep.train_state_specs(jcfg, jt, JComp(scheme="dgcwgmf"), jp, jm)
        tspec = tstep.train_state_specs(tcfg, tt, TComp(scheme="dgcwgmf"), tp, tm)
        for field in ("params", "opt", "sstate", "gbar", "step"):
            assert_same_specs(getattr(tspec, field), getattr(jspec, field), (sync, field))
        axis = {"dense": None, "gmf_data": "data", "gmf_pod": "pod"}[sync]
        sizes = dict(zip(axes_of(shape), shape, strict=True))
        # FSDP over a data axis > 1 (the >40 B archs) is part C too
        fsdp_data = tstep.needs_fsdp(tcfg) and sizes["data"] > 1
        for field in ("u", "v", "m"):
            ref = j_leaves(getattr(jspec.cstate, field))
            got = tree_leaves(getattr(tspec.cstate, field))
            assert bool(ref) == bool(got), (sync, field)
            assert all(tuple(p) == (axis,) for p in got), (sync, field, got)
            for spec in ref:
                assert spec[0] == axis, (sync, field, spec)
                rest = [a for e in spec[1:] if e is not None
                        for a in (e if isinstance(e, tuple) else (e,))]
                if sizes["model"] == 1 and not fsdp_data:
                    assert all(sizes[a] == 1 for a in rest), (sync, field, spec)
        # FSDP (part C2a): the leaves whose specs name data are the ones the
        # forward gathers over it, and only where FSDP is on
        assert tstep.fsdp_active(tcfg, tm) == fsdp_data
        gathered = [d is not None for d in tree_leaves(tshr.fsdp_dims(tp, tm))]
        named = ["data" in tshr.spec_axes(s)
                 for s in tree_leaves(tshr.param_specs(tp, fsdp=True, mesh=tm))]
        assert gathered == named, (sync, gathered, named)


def test_grouped_layout_stacks_one_spec_a_group():
    """A tree of mixed dtypes (a bf16 model's float32 router) keeps one
    flat stack a dtype group, and one ``P(axis)`` each."""
    cfg = dataclasses.replace(tconfigs.get_smoke("granite-moe-1b-a400m"), dtype="bfloat16",
                              param_dtype="bfloat16")
    params = ttr.abstract_params(cfg)
    spec = tstep.train_state_specs(cfg, TTrain(grad_sync="gmf_data"), TComp(scheme="dgcwgmf"),
                                   params, tmesh.AbstractMesh((4, 1), ("data", "model")))
    assert spec.cstate.u == (tshr.P("data"), tshr.P("data"))


def test_spec_class_normalises_like_partition_spec():
    for entries in [(("data",), None), (("pod", "data"),), ("model",), (None, "data"), ()]:
        assert tuple(tshr.P(*entries)) == tuple(PartitionSpec(*entries))
    assert tshr.strip_axes(tshr.P(("pod", "data"), "model"), {"pod"}) == tshr.P("data", "model")
    assert tuple(tshr.strip_axes(tshr.P(("pod", "data"), "model"), {"pod"})) == tuple(
        jshr.strip_axes(PartitionSpec(("pod", "data"), "model"), {"pod"}))


def test_mesh_functions_need_a_world_and_its_size():
    if dist.is_initialized():
        pytest.fail("a process group leaked from another test")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.AbstractMesh((2, 2), ("data",))
    m = tmesh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert m.size() == 512 and m.size(1) == 16 and tmesh.axis_size(m, "model") == 16
    assert tmesh.axis_size(tmesh.AbstractMesh((4,), ("clients",)), "model") == 1


@pytest.fixture
def world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_in_a_one_rank_world(world):
    m = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    assert tmesh.mesh_axes(m) == ("data", "model") and tuple(m.shape) == (1, 1)
    assert m.device_type == "cpu"
    m3 = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    assert tmesh.has_pod_axis(m3) and not tmesh.has_pod_axis(m)
    assert dist.get_world_size(m3.get_group("pod")) == 1
    # the reference's message for a mesh larger than the world (a smaller
    # one takes the first ranks: tests/test_torch_dist_step.py)
    with pytest.raises(ValueError, match=r"Number of devices 1 must be >= the product of "
                                         r"mesh_shape \(2, 1\)"):
        tmesh.make_mesh((2, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="requested 2 shards but only 1 devices are visible"):
        tmesh.make_client_mesh(2, "cpu")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"exactly {n} ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cm = tmesh.make_client_mesh(device_type="cpu")
    assert tmesh.mesh_axes(cm) == ("clients",) and tuple(cm.shape) == (1,)


def test_shard_engine_takes_a_client_mesh(world):
    """The shard engine over a client mesh's group is the vmap engine at
    one rank, bitwise (as it is over the world group)."""
    import test_torch_shard as ts

    want = ts.state(ts.run("star", "vmap"))
    sim = ts.run("star", "shard", group=tmesh.make_client_mesh(device_type="cpu"))
    assert sim.engine.shards.world == 1
    got = ts.state(sim)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key], want[key]), key


def test_health_norms_over_a_group(world):
    """The trainer's health block over a mesh sums every segment's squares
    over the group its spans name (``obs.health.NormSpan``; the whole
    model's norms at any mesh, ROADMAP F7, in
    ``tests/test_torch_dist_step.py``): at one rank, the norms of the
    rank's rows and broadcast (float32 roundings apart)."""
    from repro_torch.core.state import ClientState, ServerState
    from repro_torch.obs.health import NormSpan, compensation_norms
    from repro_torch.utils.flat import FlatLayout

    rng = np.random.default_rng(0)
    rows = [torch.from_numpy(rng.normal(size=(1, 50)).astype(np.float32)) for _ in range(3)]
    cst, sst, bcast = ClientState(*rows), ServerState(momentum={}, residual={}), rows[0][0]
    want = compensation_norms(cst, sst, bcast)
    layout = FlatLayout.of_sizes([20, 30], "cpu")
    span = NormSpan(layout.segments, dist.group.WORLD, (True, True), (True, True))
    got = compensation_norms(cst, sst, bcast, spans={"client": span, "server": span})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_named_shardings_place_and_cut_leaves(world):
    """``named_shardings``' placements, and ``local_tree`` / ``full_tree``
    at one rank: the local piece is the whole leaf, and gathers back."""
    from torch.distributed.tensor import Replicate, Shard

    m = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    specs = {"a": tshr.P(("pod", "data"), None, "model"), "b": tshr.P()}
    sh = tshr.named_shardings(m, specs)
    assert sh["a"].placements == (Shard(0), Shard(0), Shard(2))
    assert sh["b"].placements == (Replicate(),) * 3
    tree = {"a": torch.arange(24.0).reshape(2, 3, 4), "b": torch.ones(3)}
    local = tshr.local_tree(tree, sh)
    assert all(torch.equal(local[k], tree[k]) for k in tree)
    back = tshr.full_tree(local, sh)
    assert all(torch.equal(back[k], tree[k]) for k in tree)


@pytest.mark.parametrize("own", [False, True], ids=["summed", "client"])
def test_fsdp_gathers_one_layer_group_at_a_time_under_remat(world, own):
    """Under ``cfg.remat`` a layer group's FSDP gather runs inside its
    checkpoint: once the forward is done, no group's gathered leaf is still
    alive (only the embedding's and the unembedding's, taken outside the
    groups), the backward gathers every group again, and the gradients
    (the pieces', or the sink's under ``gmf_data``) are the forward's
    without FSDP, bitwise, at a data group of one rank."""
    import weakref

    from repro_torch.utils import collectives as col
    from repro_torch.utils import tree_map

    cfg = dataclasses.replace(tconfigs.get_smoke("llama3.2-1b"), num_layers=3, remat=True)
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    m = tmesh.make_mesh((1, 1), ("data", "model"), "cpu")
    dims = tshr.fsdp_dims(ttr.abstract_params(cfg), m)
    fs = ttr.FsdpCtx(m.get_group("data"), dims, {} if own else None)

    def grads(ctx):
        live = tree_map(lambda x: x.detach().requires_grad_(True), params)
        logits, _, _ = ttr.forward(cfg, live, {"tokens": tokens}, ctx=ctx)
        return logits, live

    want_logits, live = grads({})
    want = torch.autograd.grad(want_logits.float().square().sum(), tree_leaves(live))

    made = []
    real = col._all_gather

    def tracked(x, group, dim):
        out = real(x, group, dim)
        made.append(weakref.ref(out))
        return out

    col._all_gather = tracked
    try:
        logits, live = grads({"fsdp": fs})
        alive = sum(r() is not None for r in made)
        n_forward = len(made)
        leaves = tree_leaves(live)
        got = torch.autograd.grad(logits.float().square().sum(), leaves, allow_unused=True)
    finally:
        col._all_gather = real
    n_layer = sum(d is not None for d in tree_leaves(dims["layers"]))
    n_edge = sum(d is not None for k in ("embed", "unembed") for d in tree_leaves(dims[k]))
    assert n_layer > 0 and n_forward == cfg.num_layers * n_layer + n_edge
    assert alive <= n_edge, (alive, n_edge)
    assert len(made) == n_forward + cfg.num_layers * n_layer  # remat gathers again
    assert torch.equal(logits, want_logits)
    for x, g, w, d in zip(leaves, got, want, tree_leaves(dims), strict=True):
        if own and d is not None:
            g = fs.sink.get((id(x), None))
            if g is None:
                g = torch.stack([fs.sink[(id(x), i)] for i in range(x.shape[0])])
        assert torch.equal(g, w)
