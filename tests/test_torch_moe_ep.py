"""The port's expert-parallel MoE (``repro_torch.models.moe``:
``dispatch_local``, ``combine_local``, ``moe_ep`` and its two bodies)
against the JAX package's.

- ``dispatch_local`` and ``combine_local`` in process, no collective:
  bitwise JAX's (buffer, order, positions, keep, rows) at capacities that
  keep and drop assignments, top-2 and top-8; the combine adds a token's
  rows in the reference scatter's order (sorted assignments, from zeros).
- ``moe_ep`` at a one-rank (1, 1) mesh in process (a gloo world of one
  rank, JAX's real (1, 1) mesh): within 1e-5 of JAX's ``moe_ep`` and of
  ``moe_dense`` where nothing drops; its gradients within 1e-5 of
  ``moe_dense``'s there.
- ``moe_ep`` at (data 2, model 2), four ranks spawned (a gloo world of
  four processes from a ``file://`` store, ``torch.set_num_threads(1)``,
  beside the JAX package's run on four faked devices,
  ``tests/torch_mesh_*.py``): the all-to-all body (T = 8) and the
  all-reduce body (T = 1), with the expert weights whole on their rank or
  their f dim over ``data`` (FSDP): y within 1e-5 of JAX's and, at a
  generous capacity, of ``moe_dense``; aux within 1e-6 of JAX's; the two
  model ranks of a data row hold the same y bitwise, and FSDP's y is the
  unsharded one's bitwise. In the same world, ``moe_ep(..., tp=...)`` as
  a forward under tensor parallelism runs it (the tokens replicated over
  the model group): y and the gradients of the tokens, the router and the
  rank's experts within 1e-5 of ``jax.grad`` through the reference's
  ``shard_map``, on both bodies, with and without FSDP.
"""

import dataclasses
import datetime

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro.configs.base import ModelConfig as JModel  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModel  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

REL = 1e-5


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def routed(tl, e, k, d, seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(tl, e)).astype(np.float32)
    eids = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
    gates = rng.uniform(0.1, 1.0, size=(tl, k)).astype(np.float32)
    x = rng.normal(size=(tl, d)).astype(np.float32)
    return x, eids, gates


@pytest.mark.parametrize("k, e_base, e_loc, capacity", [
    (2, 0, 8, 16), (2, 0, 8, 3), (2, 4, 4, 2), (8, 0, 16, 40), (8, 8, 8, 5)])
def test_dispatch_and_combine_are_jax_bitwise(k, e_base, e_loc, capacity):
    tl, e, d = 24, 16, 8
    x, eids, gates = routed(tl, e, k, d, seed=k + capacity)
    jout = jmoe.dispatch_local(jnp.asarray(x), jnp.asarray(eids), jnp.asarray(gates), e_base,
                               e_loc, capacity)
    tout = tmoe.dispatch_local(torch.from_numpy(x), torch.from_numpy(eids).long(),
                               torch.from_numpy(gates), e_base, e_loc, capacity)
    for name, got, want in zip(("buf", "tok_s", "p_idx", "keep", "e_idx", "gate_s"), tout, jout,
                               strict=True):
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    kept = int(tout[3].sum())
    assert (kept < tl * k) == (capacity * e_loc < tl * k or e_loc < e)  # drops where they must
    y = np.random.default_rng(1).normal(size=(e_loc, capacity, d)).astype(np.float32)
    jy = jmoe.combine_local(jnp.asarray(y), *jout[1:], tl)
    ty = tmoe.combine_local(torch.from_numpy(y), *tout[1:], tl)
    assert np.array_equal(ty.numpy(), np.asarray(jy))
    assert torch.equal(ty, tmoe.combine_local(torch.from_numpy(y), *tout[1:], tl))


def configs(capacity):
    return JModel(**cases.MOE, capacity_factor=capacity), TModel(**cases.MOE,
                                                                 capacity_factor=capacity)


def moe_inputs(seed=2):
    jcfg, tcfg = configs(8.0)
    p = tmoe.init_moe(torch.Generator().manual_seed(seed), tcfg)
    rng = np.random.default_rng(0)
    xs = {path: rng.normal(size=shape).astype(np.float32) for path, shape in cases.MOE_X.items()}
    return p, xs


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("capacity", list(cases.MOE_CAPACITY.values()))
def test_one_rank_moe_ep_against_jax_and_dense(one_rank, capacity):
    jcfg, tcfg = configs(capacity)
    p, xs = moe_inputs()
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    jm = jmake_mesh((1, 1), ("data", "model"))
    tm = make_mesh((1, 1), ("data", "model"), "cpu")
    for path, x in xs.items():
        jy, jaux = jax.jit(lambda p, x: jmoe.moe_ep(p, jcfg, x, mesh=jm, data_axes=("data",),
                                                     model_axis="model",
                                                     fsdp_weights=False))(jp, jnp.asarray(x))
        with torch.no_grad():
            ty, taux = tmoe.moe_ep(p, tcfg, torch.from_numpy(x), mesh=tm, data_axes=("data",),
                                   model_axis="model", fsdp_weights=False)
        assert rel_err(ty, jy) <= REL and abs(float(taux) - float(jaux)) <= 1e-6, path
        if capacity >= 8.0:  # nothing drops: the dense dispatch's function
            yd, auxd = tmoe.moe_dense(p, tcfg, torch.from_numpy(x))
            assert rel_err(ty, yd) <= REL and float(taux) == float(auxd), path


def test_one_rank_moe_ep_gradients_are_dense_dispatch_gradients(one_rank):
    _, tcfg = configs(8.0)
    p, xs = moe_inputs()
    tm = make_mesh((1, 1), ("data", "model"), "cpu")
    x = torch.from_numpy(xs["a2a"])
    grads = []
    for fn in (lambda q, x: tmoe.moe_ep(q, tcfg, x, mesh=tm, data_axes=("data",),
                                        model_axis="model", fsdp_weights=False),
               lambda q, x: tmoe.moe_dense(q, tcfg, x)):
        q = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xr = x.clone().requires_grad_(True)
        y, aux = fn(q, xr)
        ((y * y).sum() + aux).backward()
        grads.append([q[k].grad for k in sorted(q)] + [xr.grad])
    for got, want in zip(*grads, strict=True):
        assert rel_err(got, want) <= REL




@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    import torch_mesh_ranks as ranks

    work = tmp_path_factory.mktemp("moe4")
    p, xs = moe_inputs()
    inputs = {f"moe/{k}": v.numpy() for k, v in p.items()}
    inputs.update({f"x/{path}": x for path, x in xs.items()})
    rng = np.random.default_rng(4)
    inputs.update({f"w/{path}": rng.normal(size=x.shape).astype(np.float32)
                   for path, x in xs.items()})
    np.savez(work / "inputs.npz", **inputs)
    jres, rres = ranks.spawn("moe", work, work / "inputs.npz")
    return jres, rres, p, xs


@pytest.mark.parametrize("fsdp", [0, 1])
@pytest.mark.parametrize("path", list(cases.MOE_X))
@pytest.mark.parametrize("cap_name", list(cases.MOE_CAPACITY))
def test_four_ranks_moe_ep_against_jax(world4, cap_name, path, fsdp):
    jres, rres, p, xs = world4
    key = f"{cap_name}/{path}/{fsdp}"
    nd, nm = cases.MOE_MESH
    # rank r sits at (data r // nm, model r % nm): a data row's y from its
    # first model rank, the others bitwise equal to it
    for r in range(cases.WORLD):
        assert np.array_equal(rres[r][f"{key}/y"], rres[r - r % nm][f"{key}/y"]), (key, r)
        assert np.array_equal(rres[r][f"{key}/y"], rres[r][f"{cap_name}/{path}/0/y"]), (key, r)
        assert abs(float(rres[r][f"{key}/aux"]) - float(jres[f"{key}/aux"])) <= 1e-6, key
    y = np.concatenate([rres[d * nm][f"{key}/y"] for d in range(nd)])
    assert rel_err(y, jres[f"{key}/y"]) <= REL, key
    _, tcfg = configs(cases.MOE_CAPACITY[cap_name])
    yd, _ = tmoe.moe_dense(p, tcfg, torch.from_numpy(xs[path]))
    if cap_name == "generous":
        assert rel_err(y, yd.numpy()) <= REL, key
    else:  # the tight capacity drops assignments: another function than the dense one
        assert rel_err(y, yd.numpy()) > 1e-2, key


def test_a_model_axis_over_one_raises_in_the_forward_only(world4):
    """The expert-parallel MoE inside the forward at a model axis of 2
    (ROADMAP item 11 part C2a; the name is older than the port and kept):
    ``moe_ep(..., tp=model group)`` on tokens replicated over the model
    group, every model rank holding the same loss (sum(y · w) + 0.1 · aux),
    on both bodies, the experts whole on their rank or cut over ``data``:
    y within 1e-5 of JAX's, and the gradients of the tokens, the router and
    the rank's experts within 1e-5 of ``jax.grad`` through the reference's
    ``shard_map`` (each replicated input's gradient summed over the model
    group once). The four-rank train cases run it inside the step."""
    for path in cases.MOE_X:
        for fsdp in (0, 1):
            _hold_tp_grads(world4, path, fsdp)


def _hold_tp_grads(world4, path, fsdp):
    jres, rres, _, _ = world4
    key = f"tp/{path}/{fsdp}"
    nd, nm = cases.MOE_MESH
    e_loc = cases.MOE["num_experts"] // nm
    f_loc = cases.MOE["d_ff"] // nd
    y = np.concatenate([rres[d * nm][f"{key}/y"] for d in range(nd)])
    assert rel_err(y, jres[f"generous/{path}/{fsdp}/y"]) <= REL
    dx = np.concatenate([rres[d * nm][f"{key}/dx"] for d in range(nd)])
    assert rel_err(dx, jres[f"{key}/dx"]) <= REL
    for r in range(cases.WORLD):
        d, m = divmod(r, nm)
        assert np.array_equal(rres[r][f"{key}/dx"], rres[d * nm][f"{key}/dx"]), r
        assert rel_err(rres[r][f"{key}/drouter"], jres[f"{key}/drouter"]) <= REL, r
        for k in ("w_gate", "w_up", "w_down"):
            want = jres[f"{key}/d{k}"][m * e_loc:(m + 1) * e_loc]
            if fsdp:
                cut = 2 if k != "w_down" else 1
                want = np.split(want, nd, axis=cut)[d]
            assert rel_err(rres[r][f"{key}/d{k}"], want) <= REL, (r, k)
