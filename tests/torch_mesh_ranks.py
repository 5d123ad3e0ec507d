"""The port's side of the four-rank mesh tests: one rank of a gloo world
(``file://`` store, no port opened) running the cases of
``tests/torch_mesh_cases.py`` on its local pieces, results to an ``.npz``.
Imports torch and the port only. Run as a subprocess a rank:

    python tests/torch_mesh_ranks.py train|moe RANK WORLD INIT INPUTS.npz OUT.npz
"""

import dataclasses
import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_mesh_cases as cases  # noqa: E402
from repro_torch import configs, obs  # noqa: E402
from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core import CompressionConfig  # noqa: E402
from repro_torch.dist import sharding as shr  # noqa: E402
from repro_torch.dist import step as dstep  # noqa: E402
from repro_torch.launch.mesh import in_mesh, make_client_mesh, make_mesh  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.obs.collectives import CollectiveTally  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.utils.flat import FlatLayout  # noqa: E402


def whole_rows(row, whole, mesh, fsdp=False):
    """A rank's flat ``[1, N]`` row of its pieces of the leaves ``whole``
    (cut by the tensor-parallel specs, and over data too under ``fsdp``) as
    the row of the whole leaves (the pieces gathered)."""
    specs = [shr.P(None, *tuple(s))
             for s in tree_leaves(shr.param_specs(whole, fsdp=fsdp, mesh=mesh))]
    pieces = shr.local_tree(whole, shr.named_shardings(mesh, shr.param_specs(
        whole, fsdp=fsdp, mesh=mesh)))
    local = FlatLayout.of(pieces).unflatten(row)
    leaves = [shr.full_tree(x, shr.NamedSharding(mesh, s))
              for x, s in zip(tree_leaves(local), specs, strict=True)]
    return np.concatenate([x.reshape(1, -1).numpy() for x in leaves], axis=1)


def whole_params(inp, cfg, arch):
    like = transformer.abstract_params(cfg)
    return tree_unflatten(like, [torch.from_numpy(inp[f"params/{arch}/{i}"].copy())
                                 for i in range(len(tree_leaves(like)))])


def health(state, cfg, tcfg, mesh, out, name):
    """The trainer's health norms (``obs.health.compensation_norms`` over
    ``dist.step.health_spans``), and as they were summed before ROADMAP F7's
    repair: the client norms' squares over the sync group alone, the
    server's and the broadcast's the rank's own."""
    spans = dstep.health_spans(cfg, tcfg, mesh, state.params)
    new = obs.health.compensation_norms(state.cstate, state.sstate, state.gbar, spans=spans)
    old = obs.health.compensation_norms(state.cstate, state.sstate, state.gbar)
    sq = torch.tensor([old[k] ** 2 for k in ("residual_u_norm", "residual_v_norm",
                                             "momentum_m_norm")])
    dist.all_reduce(sq, group=dstep.sync_group(tcfg.grad_sync, mesh))
    old.update(zip(("residual_u_norm", "residual_v_norm", "momentum_m_norm"),
                   torch.sqrt(sq).tolist()))
    for tag, block in (("new", new), ("old", old)):
        out[f"{name}/health/{tag}"] = np.asarray([block[k] for k in HEALTH_KEYS])
    # a NaN on rank 1's piece of the broadcast alone
    poisoned = tree_map(lambda x: x.clone(), state.gbar)
    if dist.get_rank() == 1:
        tree_leaves(poisoned)[0].view(-1)[0] = float("nan")
    block = obs.health.compensation_norms(state.cstate, state.sstate, poisoned, spans=spans)
    out[f"{name}/health/finite"] = np.asarray([new["broadcast_finite"],
                                               block["broadcast_finite"]])


HEALTH_KEYS = ("residual_u_norm", "residual_v_norm", "momentum_m_norm", "server_momentum_norm",
               "broadcast_norm")


def places_match(params) -> bool:
    """Whether each cut layout over this rank's pieces (the step's rows,
    made ``over`` its group with the places the specs give) holds the
    shared flags and every rank's boxes and owner flags that the group's
    collectives give: the not-owner flags all-reduced, each rank's boxes'
    starts and owner flags all-gathered."""
    base = FlatLayout.of(params)
    lays = [g for lay in base._over.values()
            for g in (lay.groups if lay.groups is not None else (lay,)) if g.cut]
    ok = bool(lays)
    for lay in lays:
        others = torch.tensor([int(not o) for o in lay.owner_flags], dtype=torch.int64)
        dist.all_reduce(others, group=lay.group)
        ok &= tuple(bool(x) for x in others.tolist()) == lay.shared_flags
        nd = max(len(s) for s in lay.shapes)
        mine = torch.zeros(lay.num_leaves, nd + 1, dtype=torch.int64)
        for j, (box, own) in enumerate(zip(lay.boxes, lay.owner_flags, strict=True)):
            mine[j, :len(box.start)] = torch.tensor(box.start, dtype=torch.int64)
            mine[j, nd] = int(own)
        parts = [torch.empty_like(mine) for _ in range(dist.get_world_size(lay.group))]
        dist.all_gather(parts, mine, group=lay.group)
        for part, (owners, boxes) in zip(parts, lay.places, strict=True):
            ok &= [row[-1] for row in part.tolist()] == [int(o) for o in owners]
            ok &= [row[:len(b.start)] for row, b in zip(part.tolist(), boxes, strict=True)] \
                == [list(b.start) for b in boxes]
    return ok


def train(inp, out, ckpt):
    for name, (arch, over, shape, sync) in cases.TRAIN.items():
        cfg = dataclasses.replace(configs.get_smoke(arch), **over)
        mesh = make_mesh(shape, cases.axes_of(shape), "cpu")
        if not in_mesh(mesh):  # a rank past the mesh takes no part
            continue
        fsdp = name in cases.FSDP
        dstep._FSDP_PARAM_THRESHOLD = 0 if fsdp else 40e9
        whole = whole_params(inp, cfg, arch)
        p_sh = shr.named_shardings(mesh, shr.param_specs(whole, fsdp=fsdp, mesh=mesh))
        params = shr.local_tree(whole, p_sh)
        tcfg = TrainConfig(learning_rate=cases.LR, total_steps=10, grad_sync=sync,
                           lr_schedule="cosine", warmup_steps=1)
        ccfg = CompressionConfig(**cases.scheme_of(name))
        state = dstep.init_train_state(cfg, tcfg, ccfg, params, mesh)
        step = dstep.make_train_step(cfg, tcfg, ccfg, mesh)
        b_sh = shr.named_shardings(mesh, dstep.step_batch_specs(cfg, tcfg, mesh))
        for t in range(cases.STEPS):
            batch = {k: torch.from_numpy(inp[f"batch/{arch}/{t}/{k}"].copy())
                     for k in cases.BATCH_KEYS if f"batch/{arch}/{t}/{k}" in inp}
            batch = {k: x.long() if k != "patch_embeds" else x for k, x in batch.items()}
            if t == 0 and name in cases.TALLY:
                with CollectiveTally() as tally:
                    state, m = step(state, shr.local_tree(batch, b_sh))
                out[f"{name}/tally"] = np.asarray(json.dumps(
                    {"counts": tally.counts, "bytes": tally.bytes}))
            else:
                state, m = step(state, shr.local_tree(batch, b_sh))
            if t == 0 and name in cases.PLACES:
                out[f"{name}/places"] = np.asarray(places_match(state.params))
            out[f"{name}/loss/{t}"] = m["loss"].numpy()
            out[f"{name}/valid/{t}"] = np.asarray(
                int((shr.local_tree(batch, b_sh)["labels"] >= 0).sum()))
            if sync != "dense":
                out[f"{name}/upload_nnz/{t}"] = m["upload_nnz"].numpy()
                out[f"{name}/download_nnz/{t}"] = m["download_nnz"].numpy()
        for i, x in enumerate(tree_leaves(shr.full_tree(state.params, p_sh))):
            out[f"{name}/params/{i}"] = x.numpy()
        for i, x in enumerate(tree_leaves(state.opt)):
            out[f"{name}/opt/{i}"] = x.numpy()
        if sync != "dense":
            # the rows hold pieces cut over data too under gmf_pod's FSDP
            rows_fsdp = fsdp and sync == "gmf_pod"
            for f in ("u", "v", "m"):  # the fields the scheme keeps
                if isinstance(getattr(state.cstate, f), torch.Tensor):
                    out[f"{name}/{f}"] = whole_rows(getattr(state.cstate, f), whole, mesh,
                                                    rows_fsdp)
            if isinstance(state.gbar, torch.Tensor):
                out[f"{name}/gbar"] = whole_rows(state.gbar[None], whole, mesh, fsdp)[0]
            if name in cases.HEALTH:
                health(state, cfg, tcfg, mesh, out, name)
        dstep._FSDP_PARAM_THRESHOLD = 40e9
    # the client mesh of the first ranks: its coordinates and a sum over it
    cm = make_client_mesh(cases.CLIENT_MESH, "cpu")
    if in_mesh(cm):
        x = torch.tensor([dist.get_rank() + 1.0])
        dist.all_reduce(x, group=cm.get_group("clients"))
        out["client_mesh/coord"] = np.asarray(cm.get_coordinate())
        out["client_mesh/sum"] = x.numpy()
    # a checkpoint restored onto (4, 1), its leaves cut over data (FSDP's specs)
    arch = cases.ARCHS[0]
    cfg = configs.get_smoke(arch)
    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    like = whole_params(inp, cfg, arch)
    sh = shr.named_shardings(mesh, shr.param_specs(like, fsdp=True, mesh=mesh))
    local = restore(ckpt, like, shardings=sh)
    for i, x in enumerate(tree_leaves(local)):
        out[f"restore/local/{i}"] = x.numpy()
    for i, x in enumerate(tree_leaves(shr.full_tree(local, sh))):
        out[f"restore/full/{i}"] = x.numpy()
    # and onto (2, 2) by the tensor-parallel specs: each rank its model piece
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    sh = shr.named_shardings(mesh, shr.param_specs(like, fsdp=False, mesh=mesh))
    for i, x in enumerate(tree_leaves(restore(ckpt, like, shardings=sh))):
        out[f"restore22/local/{i}"] = x.numpy()


def moe_ep(inp, out):
    mesh = make_mesh(cases.MOE_MESH, ("data", "model"), "cpu")
    d, m = mesh.get_coordinate()
    nd, nm = cases.MOE_MESH
    for cap_name, cap in cases.MOE_CAPACITY.items():
        cfg = ModelConfig(**cases.MOE, capacity_factor=cap)
        whole = {k: torch.from_numpy(inp[f"moe/{k}"].copy())
                 for k in ("router", "w_gate", "w_up", "w_down")}
        e_loc, f_loc = cfg.num_experts // nm, cfg.d_ff // nd
        mine = {"router": whole["router"]}
        for k in ("w_gate", "w_up", "w_down"):
            mine[k] = whole[k][m * e_loc:(m + 1) * e_loc]
        fsdp_mine = dict(mine, w_gate=mine["w_gate"][:, :, d * f_loc:(d + 1) * f_loc],
                         w_up=mine["w_up"][:, :, d * f_loc:(d + 1) * f_loc],
                         w_down=mine["w_down"][:, d * f_loc:(d + 1) * f_loc])
        for path in cases.MOE_X:
            x = torch.from_numpy(inp[f"x/{path}"].copy())
            b = x.shape[0] // nd
            for fsdp, p in ((False, mine), (True, fsdp_mine)):
                with torch.no_grad():
                    y, aux = moe.moe_ep(p, cfg, x[d * b:(d + 1) * b], mesh=mesh,
                                        data_axes=("data",), model_axis="model",
                                        fsdp_weights=fsdp)
                out[f"{cap_name}/{path}/{int(fsdp)}/y"] = y.numpy()
                out[f"{cap_name}/{path}/{int(fsdp)}/aux"] = aux.numpy()
                if cap_name == "generous":
                    moe_ep_grads(inp, out, cfg, mesh, p, x[d * b:(d + 1) * b], d * b, path,
                                 fsdp)


def moe_ep_grads(inp, out, cfg, mesh, p, x, row0, path, fsdp):
    """``moe_ep(..., tp=model group)`` as a forward under tensor parallelism
    runs it: every model rank holds the same loss, each data rank its share
    (its rows, and the aux over the data ranks' count). The gradients of x
    (the rank's rows), of the router and of the rank's experts, the last
    two summed over the data ranks (the dense step's sum; FSDP's gather sums
    its pieces itself)."""
    model, data = mesh.get_group("model"), mesh.get_group("data")
    live = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    xl = x.detach().clone().requires_grad_(True)
    w = torch.from_numpy(inp[f"w/{path}"][row0:row0 + x.shape[0]].copy())
    y, aux = moe.moe_ep(live, cfg, xl, mesh=mesh, data_axes=("data",), model_axis="model",
                        fsdp_weights=fsdp, tp=model)
    loss = torch.sum(y * w) + cases.MOE_AUX / dist.get_world_size(data) * aux
    grads = torch.autograd.grad(loss, [xl] + [live[k] for k in sorted(live)])
    key = f"tp/{path}/{int(fsdp)}"
    out[f"{key}/y"] = y.detach().numpy()
    out[f"{key}/dx"] = grads[0].numpy()
    for k, g in zip(sorted(live), grads[1:], strict=True):
        if k == "router" or not fsdp:
            dist.all_reduce(g, group=data)
        out[f"{key}/d{k}"] = g.numpy()


if __name__ == "__main__":
    what, rank, world, init, inputs, dest = sys.argv[1:7]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = np.load(inputs)
        res: dict = {}
        if what == "train":
            train(inp, res, os.path.join(os.path.dirname(inputs), "ck"))
        else:
            moe_ep(inp, res)
        np.savez(dest, **res)
    finally:
        dist.destroy_process_group()


JAX_PARTS = {"train": 3, "moe": 1}  # JAX processes a world's cases are shared over


def spawn(what: str, workdir, inputs, timeout: float = 300.0):
    """Run ``what`` in a gloo world of ``cases.WORLD`` rank processes and,
    at the same time, the JAX package's run of it on four faked devices
    (its cases shared over ``JAX_PARTS[what]`` processes), each with its
    own timeout. Returns (JAX results, [rank results]); a process that
    fails raises with its output."""
    import subprocess
    from pathlib import Path

    here = Path(__file__).resolve().parent
    workdir = Path(workdir)
    env = dict(os.environ, PYTHONPATH=str(here.parent / "src"), OMP_NUM_THREADS="1")
    init = f"file://{workdir / 'store'}"
    parts = JAX_PARTS[what]
    jax_outs = [workdir / f"jax{i}.npz" for i in range(parts)]
    procs = [subprocess.Popen([sys.executable, str(here / "torch_mesh_jax.py"), what,
                               str(inputs), str(jax_outs[i]), str(i), str(parts)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(parts)]
    procs += [subprocess.Popen([sys.executable, str(here / "torch_mesh_ranks.py"), what, str(r),
                                str(cases.WORLD), init, str(inputs),
                                str(workdir / f"rank{r}.npz")], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for r in range(cases.WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("\n".join(f"--- process {i} (rc {p.returncode}):\n{log[-4000:]}"
                                     for i, (p, log) in enumerate(zip(procs, logs, strict=True))))
    jres: dict = {}
    for out in jax_outs:
        jres.update(np.load(out))
    return jres, [dict(np.load(workdir / f"rank{r}.npz")) for r in range(cases.WORLD)]
