"""The JAX package's side of the four-rank mesh tests: the cases of
``tests/torch_mesh_cases.py`` on four faked CPU devices, from the inputs
the test wrote (params, batches, MoE weights and tokens as numpy), results
to an ``.npz``. Run as a subprocess (``XLA_FLAGS`` must be set before jax
starts); ``PART`` of ``PARTS`` takes every PARTS-th train case from the
PART-th, so that several processes share the cases (each JAX process
compiles on one thread):

    python tests/torch_mesh_jax.py train|moe INPUTS.npz OUT.npz [PART PARTS]
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro import configs  # noqa: E402
from repro.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro.core import CompressionConfig  # noqa: E402
from repro.dist import sharding as shr  # noqa: E402
from repro.dist import step as dstep  # noqa: E402
from repro.launch.mesh import make_client_mesh, make_mesh  # noqa: E402
from repro.models import moe, transformer  # noqa: E402


def put(mesh, tree, specs):
    return jax.device_put(tree, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), specs, is_leaf=lambda x: isinstance(x, PartitionSpec)))


def flat_rows(tree, n):
    """A stacked ``[n, ...]`` tree as the port's flat ``[n, N]`` stack."""
    return np.concatenate([np.asarray(x).reshape(n, -1)
                           for x in jax.tree_util.tree_leaves(tree)], axis=1)


def train(inp, out, part=0, parts=1):
    for i, (name, (arch, over, shape, sync)) in enumerate(cases.TRAIN.items()):
        if i % parts != part:
            continue
        # FSDP's cases: the smoke configs fall under the 40e9 threshold
        dstep._FSDP_PARAM_THRESHOLD = 0 if name in cases.FSDP else 40e9
        cfg = dataclasses.replace(configs.get_smoke(arch), **over)
        like = jax.eval_shape(lambda cfg=cfg: transformer.init_params(cfg, jax.random.PRNGKey(0)))
        leaves = [jnp.asarray(inp[f"params/{arch}/{i}"])
                  for i in range(len(jax.tree_util.tree_leaves(like)))]
        params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like), leaves)
        shape = cases.JAX_SHAPE.get(name, shape)
        mesh = make_mesh(shape, cases.axes_of(shape))
        tcfg = TrainConfig(learning_rate=cases.LR, total_steps=10, grad_sync=sync,
                           lr_schedule="cosine", warmup_steps=1)
        ccfg = CompressionConfig(**cases.scheme_of(name))
        state = dstep.init_train_state(cfg, tcfg, ccfg, params, mesh)
        state = put(mesh, state, dstep.train_state_specs(cfg, tcfg, ccfg, params, mesh))
        step = jax.jit(dstep.make_train_step(cfg, tcfg, ccfg, mesh))
        for t in range(cases.STEPS):
            batch = {k: jnp.asarray(inp[f"batch/{arch}/{t}/{k}"]) for k in cases.BATCH_KEYS
                     if f"batch/{arch}/{t}/{k}" in inp}
            state, m = step(state, put(mesh, batch, shr.train_batch_specs(cfg, mesh)))
            out[f"{name}/loss/{t}"] = np.asarray(m["loss"])
            if sync != "dense":
                out[f"{name}/upload_nnz/{t}"] = np.asarray(m["upload_nnz"])
                out[f"{name}/download_nnz/{t}"] = np.asarray(m["download_nnz"])
        for i, x in enumerate(jax.tree_util.tree_leaves(state.params)):
            out[f"{name}/params/{i}"] = np.asarray(x)
        if sync != "dense":
            n = shape[cases.axes_of(shape).index("data" if sync == "gmf_data" else "pod")]
            for f in ("u", "v", "m"):  # the fields the scheme keeps
                if jax.tree_util.tree_leaves(getattr(state.cstate, f)):
                    out[f"{name}/{f}"] = flat_rows(getattr(state.cstate, f), n)
            if jax.tree_util.tree_leaves(state.gbar):
                out[f"{name}/gbar"] = flat_rows(jax.tree_util.tree_map(lambda x: x[None],
                                                                       state.gbar), 1)[0]
        out[f"{name}/devices"] = np.asarray([d.id for d in mesh.devices.flat])
        dstep._FSDP_PARAM_THRESHOLD = 40e9
    if part == 0:
        out["client_mesh/devices"] = np.asarray([d.id for d in make_client_mesh(
            cases.CLIENT_MESH).devices.flat])


def moe_ep(inp, out):
    mesh = make_mesh(cases.MOE_MESH, ("data", "model"))
    for cap_name, cap in cases.MOE_CAPACITY.items():
        cfg = ModelConfig(**cases.MOE, capacity_factor=cap)
        p = {k: jnp.asarray(inp[f"moe/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
        for path in cases.MOE_X:
            x = jnp.asarray(inp[f"x/{path}"])
            for fsdp in (False, True):
                y, aux = jax.jit(lambda p, x, cfg=cfg, fsdp=fsdp: moe.moe_ep(
                    p, cfg, x, mesh=mesh, data_axes=("data",), model_axis="model",
                    fsdp_weights=fsdp))(p, x)
                out[f"{cap_name}/{path}/{int(fsdp)}/y"] = np.asarray(y)
                out[f"{cap_name}/{path}/{int(fsdp)}/aux"] = np.asarray(aux)
                if cap_name == "generous":
                    w = jnp.asarray(inp[f"w/{path}"])

                    def loss(p, x, cfg=cfg, fsdp=fsdp, w=w):
                        y, aux = moe.moe_ep(p, cfg, x, mesh=mesh, data_axes=("data",),
                                            model_axis="model", fsdp_weights=fsdp)
                        return jnp.sum(y * w) + cases.MOE_AUX * aux

                    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
                    key = f"tp/{path}/{int(fsdp)}"
                    out[f"{key}/dx"] = np.asarray(gx)
                    for k in sorted(gp):
                        out[f"{key}/d{k}"] = np.asarray(gp[k])


if __name__ == "__main__":
    what, inputs, dest = sys.argv[1:4]
    assert jax.device_count() == 4
    inp = np.load(inputs)
    res: dict = {}
    if what == "train":
        train(inp, res, *(int(x) for x in sys.argv[4:6]))
    else:
        moe_ep(inp, res)
    np.savez(dest, **res)
    print("OK", what, len(res))
