"""Training entry point: the port of the reference's ``launch/train.py``,
with its flags and its exit code (0 if the loss improved, 2 if not).

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 4 \
        --batch 8 --seq-len 256 --grad-sync gmf_data       # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --smoke --device cpu --steps 12 --batch 8 --seq-len 64
    torchrun --nproc-per-node 1 -m repro_torch.launch.train --arch llama3.2-1b \
        --mesh-shape 1,1 --grad-sync gmf_data --steps 4    # over a mesh

``--backend dist`` (the default) runs ``dist.step.make_train_step``: dense
data parallelism, or one GMF client (``--grad-sync gmf_data``) whose
gradient goes through the compression scheme with its own error-feedback
state; per-step metrics include the exact compressed-sync traffic (upload
nnz, broadcast nnz). ``--backend fl`` trains the same LM through the
synchronous FL round engines (``fl.LMTask`` through ``FLSimulator``, with
the ``--topology`` axis) and ``--backend async`` through the asynchronous
buffered engine (``--buffer-size``, ``--delay-model``, ``--dropout``,
``--staleness``).

Everything runs on ``--device`` (default ``cuda``; ``--device cpu`` must
be asked for, as ``--smoke`` runs do on a machine without a card). The
model is randomly initialised from ``--seed`` on that device. The per-step
record (``--metrics-out``) keeps the reference's keys and adds the
per-shard ``upload_nnz`` and the ``download_nnz``.

A process started by ``torchrun`` (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in its environment) joins
that world (NCCL on ``cuda``, gloo on ``cpu``; rank r takes ``cuda:r``)
and ``--backend dist`` trains over a mesh: ``--mesh-shape`` with the
reference's axes (``("pod", "data", "model")[-len(shape):]``), else the
reference's (n // 2, 2) for an even n ranks and (n, 1) for an odd one. A
model axis over 1 cuts the params over it (tensor parallelism, the
reference's ``_TP_RULES``), and the >40 B archs (qwen2-vl-72b,
command-r-plus-104b, kimi-k2-1t-a32b) cut them over ``data`` too on a
data axis over 1 (FSDP, ``dist.step``). With ``--obs`` the health block's
norms are the whole model's over the mesh. A mesh smaller than the world runs on its
first ranks; the others wait for its result. Rank 0 prints, writes
``--metrics-out``, the checkpoint (the params gathered) and the telemetry;
every rank returns rank 0's exit code. A single process with no world
trains on its one device, without a mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as configs
import repro_torch.obs as obs
from repro_torch.checkpoint import save as save_ckpt
from repro_torch.configs.base import TrainConfig
from repro_torch.core import SCHEMES, CompressionConfig, CostModel, resolve
from repro_torch.core.stages import get_stage
from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
from repro_torch.dist import sharding as shr
from repro_torch.dist import step as dstep
from repro_torch.launch.mesh import in_mesh, make_mesh, mesh_axes
from repro_torch.models import transformer
from repro_torch.topo import TOPOLOGIES
from repro_torch.utils import resolve_device


def parse_stage_overrides(spec: str) -> dict:
    """``selector=randomk,fusion=none`` -> CompressionConfig override kwargs.

    Keys are stage kinds; values must be registered stage names (list them
    with ``python -m repro_torch.core.registry``).
    """
    field_of = {"selector": "selector_stage", "compensator": "compensator_stage",
                "fusion": "fusion_stage", "wire": "wire_stage",
                "rotation": "rotation_stage",
                "downlink": "downlink_stage", "staleness": "staleness_stage",
                "rate_control": "rate_control_stage"}
    out = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise SystemExit(f"--stage entries are kind=name, got {part!r}")
        kind, name = (s.strip() for s in part.split("=", 1))
        if kind not in field_of:
            raise SystemExit(
                f"unknown stage kind {kind!r}; choose from {tuple(field_of)}")
        try:
            get_stage(kind, name)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        out[field_of[kind]] = name
    return out


def build_mesh(args, device_type: str = "cuda"):
    """None without a world (the one device). In a world of n ranks:
    ``--mesh-shape``'s mesh, with the reference's axes, else the
    reference's (n // 2, 2) on an even n and (n, 1) on an odd one."""
    shape = tuple(int(x) for x in args.mesh_shape.split(",")) if args.mesh_shape else None
    if not dist.is_initialized():
        if shape is not None:
            raise SystemExit("--mesh-shape needs a torch.distributed world: start one process "
                             "per rank (torchrun --nproc-per-node N -m repro_torch.launch.train)")
        return None
    if shape is None:
        n = dist.get_world_size()
        model = 2 if n % 2 == 0 else 1
        return make_mesh((n // model, model), ("data", "model"), device_type)
    return make_mesh(shape, ("pod", "data", "model")[-len(shape):], device_type)


def join_world(device: str):
    """Join the world ``torchrun`` describes in the environment, if any:
    NCCL for ``cuda`` (rank r on ``cuda:LOCAL_RANK``), gloo for ``cpu``.
    Returns the device the rank runs on."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return dev


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _finish_fl(args, sim, history, dt, unit, extra_summary):
    """The FL runs' common tail: summary lines, checkpoint, metrics
    file and the loss-improvement exit code."""
    print(f"{args.steps} {unit}s in {dt:.1f}s ({dt / args.steps * 1e3:.0f} ms/{unit})")
    print("ledger:", json.dumps(sim.ledger.summary()))
    obs.get().event("summary", wall_s=dt, **extra_summary, **sim.ledger.summary())
    if args.checkpoint:
        save_ckpt(args.checkpoint, sim.params, step=args.steps)
        print(f"checkpoint -> {args.checkpoint}.npz")
    return _write_and_judge(args, history)


def _write_and_judge(args, history) -> int:
    if args.metrics_out and _rank0():
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=2)
    first = np.mean([h["loss"] for h in history[:3]])
    last = np.mean([h["loss"] for h in history[-3:]])
    if _rank0():
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return 0 if last < first else 2


def run_async(args, ccfg, cfg):
    """LM pretraining through the asynchronous buffered FL engine
    (``FLConfig.backend="async"``): K simulated clients with sampled
    delays/dropout, buffered staleness-weighted aggregation. Same
    loss-improvement exit code as the dist path."""
    from repro_torch.fl import FLConfig, FLSimulator, LMTask

    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"async: clients={args.clients} cohort={args.cohort or args.clients} "
          f"buffer={args.buffer_size or args.cohort or args.clients} "
          f"delay={args.delay_model}(mean={args.delay_mean}) "
          f"dropout={args.dropout}")
    fl = FLConfig(
        num_clients=args.clients, rounds=args.steps,
        clients_per_round=args.cohort, batch_size=args.batch,
        learning_rate=args.lr, seed=args.seed, backend="async",
        buffer_size=args.buffer_size, delay_model=args.delay_model,
        delay_mean=args.delay_mean, delay_max=args.delay_max,
        dropout_rate=args.dropout,
    )
    task = LMTask(cfg, num_clients=args.clients, batch_size=args.batch,
                  seq_len=args.seq_len, device=args.device)
    sim = FLSimulator(fl, ccfg, task.init_fn, task.loss_fn, device=args.device)
    history = []
    t_start = time.time()

    def on_round(t, s):
        rec = dict(s.history[-1])
        rec["loss"] = task.held_out_loss(s.params)
        history.append(rec)
        if t % args.log_every == 0 or t == args.steps - 1:
            print(f"[{t:5d}] loss={rec['loss']:.4f} "
                  f"applies={rec['applies']} pending={rec['pending']} "
                  f"in_flight={rec['in_flight']} "
                  f"comm={rec['comm_gb']:.4f}GB", flush=True)

    sim.run(task.batch_provider, on_round=on_round)
    dt = time.time() - t_start
    return _finish_fl(args, sim, history, dt, "tick", {"ticks": args.steps})


def run_fl(args, ccfg, cfg):
    """LM pretraining through the synchronous FL round engines
    (``--fl-backend vmap|shard``) with the wire-graph topology axis
    (``--topology star|ring|hierarchical``). Same loss-improvement exit
    code as the dist path."""
    from repro_torch.fl import FLConfig, FLSimulator, LMTask

    topo_s = ""
    if args.topology == "ring":
        topo_s = f" hops={args.ring_hops} sync_every={args.sync_every}"
    elif args.topology == "hierarchical":
        topo_s = (f" groups={args.groups} "
                  f"tier={args.tier_scheme or '<preset>'}"
                  f"@{args.tier_rate} sync_every={args.sync_every}")
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"fl: topology={args.topology}{topo_s} clients={args.clients} "
          f"cohort={args.cohort or args.clients} "
          f"leaf_backend={args.fl_backend}")
    fl = FLConfig(
        num_clients=args.clients, rounds=args.steps,
        clients_per_round=args.cohort, batch_size=args.batch,
        learning_rate=args.lr, seed=args.seed,
        backend=args.fl_backend, shards=args.shards,
        topology=args.topology, ring_hops=args.ring_hops,
        sync_every=args.sync_every, groups=args.groups,
    )
    task = LMTask(cfg, num_clients=args.clients, batch_size=args.batch,
                  seq_len=args.seq_len, device=args.device)
    sim = FLSimulator(fl, ccfg, task.init_fn, task.loss_fn, device=args.device)
    history = []
    t_start = time.time()

    def on_round(t, s):
        rec = dict(s.history[-1])
        rec["loss"] = task.held_out_loss(s.params)
        history.append(rec)
        if t % args.log_every == 0 or t == args.steps - 1:
            if "server_ingress_gb" in rec:
                print(f"[{t:5d}] loss={rec['loss']:.4f} "
                      f"ingress={rec['server_ingress_gb']:.4f}GB "
                      f"peer={rec['peer_gb']:.4f}GB "
                      f"total={rec['comm_gb']:.4f}GB"
                      f"{' sync' if rec.get('synced') else ''}", flush=True)
            else:
                print(f"[{t:5d}] loss={rec['loss']:.4f} "
                      f"comm={rec['comm_gb']:.4f}GB", flush=True)

    sim.run(task.batch_provider, on_round=on_round)
    dt = time.time() - t_start
    return _finish_fl(args, sim, history, dt, "round", {"topology": args.topology})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU must be asked for")
    ap.add_argument("--backend", default="dist", choices=["dist", "async", "fl"],
                    help="dist = the one-device trainer (dist/step.py); async = "
                         "asynchronous buffered FL engine; fl = synchronous FL round "
                         "engines with the --topology axis (a non-star --topology "
                         "implies fl)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-sync", default="gmf_data",
                    choices=["dense", "gmf_data", "gmf_pod"])
    ap.add_argument("--scheme", default="dgcwgmf", choices=list(SCHEMES),
                    help="compression preset (list with `python -m "
                         "repro_torch.core.registry`)")
    ap.add_argument("--stage", default="",
                    help="override preset stages, e.g. "
                         "'selector=randomk,fusion=none,wire=float16,"
                         "rotation=hadamard,downlink=topk,rate_control=adaptive'")
    ap.add_argument("--rate-controller", default=None, choices=["fixed", "adaptive"],
                    help="override the preset's per-client rate controller")
    ap.add_argument("--rate", type=float, default=0.1)
    ap.add_argument("--tau", type=float, default=0.3)
    ap.add_argument("--downlink-rate", type=float, default=0.1,
                    help="topk downlink: fraction of the broadcast kept per step")
    ap.add_argument("--sketch-cols", type=int, default=10_000,
                    help="fetchsgd: count-sketch columns (upload size = rows*cols)")
    ap.add_argument("--sketch-k-frac", type=float, default=0.01,
                    help="fetchsgd: heavy-hitter fraction per round")
    ap.add_argument("--use-kernels", action="store_true",
                    help="the fused compression path (CompressionConfig.use_kernels: the "
                         "state keeps the params' dtype, gmf_select, K1 and K2 fused), as "
                         "chip_smoke.py's training phases run it; the default is the "
                         "reference's staged path, which promotes bf16 state to float32")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "float16", "bfloat16"],
                    help="sync payload dtype (16-bit = quantisation-aware EF)")
    ap.add_argument("--clients", type=int, default=8, help="fl/async: simulated clients")
    ap.add_argument("--cohort", type=int, default=0,
                    help="fl/async: clients dispatched per round (0 = all)")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="async: server flushes after this many payloads arrive "
                         "(0 = cohort size, the synchronous limit)")
    ap.add_argument("--staleness", default=None, choices=["none", "poly", "gmf_damp"],
                    help="async: override the preset's staleness weighting stage")
    ap.add_argument("--delay-model", default="none",
                    choices=["none", "uniform", "geometric", "lognormal"],
                    help="async: per-payload network delay distribution")
    ap.add_argument("--delay-mean", type=float, default=0.0,
                    help="async: mean delay in server ticks")
    ap.add_argument("--delay-max", type=int, default=0,
                    help="async: clip every delay draw (0 = uncapped)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="async: per-payload probability the upload is lost")
    ap.add_argument("--topology", default="star", choices=list(TOPOLOGIES),
                    help="fl: wire graph — star, ring or hierarchical")
    ap.add_argument("--ring-hops", type=int, default=0,
                    help="ring: payload handoffs per segment")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="ring/hierarchical: broadcast reaches clients every N rounds")
    ap.add_argument("--groups", type=int, default=1,
                    help="hierarchical: number of edge aggregators")
    ap.add_argument("--tier-scheme", default=None,
                    help="hierarchical: aggregator-tier re-compression preset")
    ap.add_argument("--tier-rate", type=float, default=0.1,
                    help="hierarchical: selector rate for the tier scheme")
    ap.add_argument("--fl-backend", default="vmap", choices=["vmap", "shard"],
                    help="fl: leaf round-engine backend")
    ap.add_argument("--shards", type=int, default=0,
                    help="fl: shard backend group size (0 = the whole group)")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2,4,1 (pod, data, model) or 4,2 (data, model) over a "
                         "torchrun world (default: (n // 2, 2) on an even n ranks, else "
                         "(n, 1))")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--obs", action="store_true",
                    help="enable the repro_torch.obs telemetry spine")
    ap.add_argument("--obs-dir", default="runs/obs", help="telemetry output directory")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.topology != "star":
        if args.backend == "async":
            raise SystemExit("--topology ring/hierarchical needs the "
                             "synchronous FL engines (--backend fl)")
        if args.backend == "dist":
            args.backend = "fl"  # a non-star topology implies the FL engines
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    overrides = parse_stage_overrides(args.stage)
    if args.staleness is not None:
        overrides["staleness_stage"] = args.staleness
    if args.rate_controller is not None:
        overrides["rate_control_stage"] = args.rate_controller
    ccfg = CompressionConfig(scheme=args.scheme, rate=args.rate, tau=args.tau,
                             wire_dtype=args.wire_dtype,
                             downlink_rate=args.downlink_rate,
                             sketch_cols=args.sketch_cols,
                             sketch_k_frac=args.sketch_k_frac,
                             tier_scheme=args.tier_scheme,
                             tier_rate=args.tier_rate,
                             use_kernels=args.use_kernels,
                             **overrides)
    scheme = resolve(ccfg)
    if args.backend == "dist":
        device = join_world(args.device)
    try:
        return _main(args, argv, ccfg, cfg, scheme, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _main(args, argv, ccfg, cfg, scheme, device):
    if not _rank0():
        return run_dist(args, ccfg, cfg, scheme, device)
    print(f"scheme={scheme.name}: selector={scheme.selector.name} "
          f"compensator={scheme.compensator.name} fusion={scheme.fusion.name} "
          f"wire={scheme.wire.name} rotation={scheme.rotation.name} "
          f"downlink={scheme.downlink.name} "
          f"staleness={scheme.staleness.name} "
          f"rate_control={scheme.rate_control.name}")
    if args.obs:
        obs.configure(args.obs_dir)
        obs.get().event("run_start", run=f"train-{args.arch}",
                        argv=sys.argv[1:] if argv is None else list(argv),
                        backend=args.backend, scheme=args.scheme, rate=args.rate,
                        steps=args.steps, topology=args.topology)
    try:
        if args.backend == "async":
            return run_async(args, ccfg, cfg)
        if args.backend == "fl":
            return run_fl(args, ccfg, cfg)
        return run_dist(args, ccfg, cfg, scheme, device)
    finally:
        if args.obs:
            obs.export.write_all(args.obs_dir)
            obs.shutdown()
            print(f"obs -> {args.obs_dir}/events.jsonl")


def run_dist(args, ccfg, cfg, scheme, device=None):
    """The trainer: ``make_train_step`` over ``--steps`` batches of the
    seeded stream, on the one device or over a mesh (each rank its piece of
    every batch), the first step timed apart (it pays the kernels' first
    use), the exact wire accounting per step."""
    device = device or resolve_device(args.device)
    mesh = build_mesh(args, device.type)
    if args.grad_sync == "gmf_pod" and (mesh is None or "pod" not in mesh_axes(mesh)):
        raise SystemExit("--grad-sync gmf_pod needs a pod axis (--mesh-shape 2,x,y)")
    if mesh is None or in_mesh(mesh):
        code = _train(args, ccfg, cfg, scheme, device, mesh)
    else:
        code = None  # a rank past the mesh takes no part: it waits for the mesh's result
    if dist.is_initialized():  # every rank returns rank 0's exit code
        box = [code]
        dist.broadcast_object_list(box, src=0)
        code = box[0]
    return code


def _train(args, ccfg, cfg, scheme, device, mesh):
    say = print if _rank0() else (lambda *a, **k: None)
    where = (f"mesh={dict(zip(mesh_axes(mesh), mesh.shape, strict=True))}" if mesh is not None
             else f"device={device}")
    say(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M {where}")

    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       grad_sync=args.grad_sync, lr_schedule="cosine",
                       warmup_steps=max(1, args.steps // 20))
    params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed))
    if mesh is not None:  # this rank's pieces (the whole at a model axis of 1)
        params = shr.local_tree(params, shr.named_shardings(mesh, shr.param_specs(
            params, fsdp=dstep.needs_fsdp(cfg), mesh=mesh)))
    state = dstep.init_train_state(cfg, tcfg, ccfg, params, mesh)
    del params
    stream = SyntheticLMStream(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len, batch_size=args.batch,
        seed=args.seed, num_codebooks=cfg.num_codebooks,
        num_patches=cfg.num_patches, d_model=cfg.d_model,
    )
    step_fn = dstep.make_train_step(cfg, tcfg, ccfg, mesh)
    b_sh = (shr.named_shardings(mesh, dstep.step_batch_specs(cfg, tcfg, mesh))
            if mesh is not None else None)
    # the health block's norms: the whole model's over the mesh (every rank's
    # rows and pieces, each piece once)
    health_spans = dstep.health_spans(cfg, tcfg, mesh, state.params) if args.obs else None
    # wire accounting from the scheme's wire stage; dense sync ships fp32
    cost = CostModel() if args.grad_sync == "dense" else scheme.cost_model()
    history = []
    total_static = float(sum(dstep.full_sizes(cfg)))  # the whole model's
    rec_obs = obs.get()
    first_s = 0.0
    steady_ms = []
    t_start = time.time()
    for step, batch in zip(range(args.steps), stream, strict=False):
        batch = to_tensors(batch, device)
        if b_sh is not None:  # this rank's rows
            batch = shr.local_tree(batch, {k: b_sh[k] for k in batch})
        _sync(device)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        # the step's one read: it waits for the step's work, so step_ms is
        # compute, not enqueue time
        rec = {"step": step, "loss": float(metrics["loss"])}  # repro-noqa: REP004 (the step's one read: step_ms waits for its work)
        step_ms = (time.perf_counter() - t_step) * 1e3
        if step == 0:
            first_s = step_ms / 1e3
            rec_obs.gauge_set("train.compile_s", first_s)
        else:
            steady_ms.append(step_ms)
            rec_obs.observe("train.step_ms", step_ms)
        rec["step_ms"] = step_ms
        up_bytes = down_bytes = up_nnz = 0.0
        if args.grad_sync != "dense":
            total = total_static
            # the counts' read lands after step_ms is measured
            shard_nnz = metrics["upload_nnz"].cpu().numpy().astype(np.float64)  # repro-noqa: REP004 (post-step_ms)
            down_nnz = float(metrics["download_nnz"])  # repro-noqa: REP004 (post-step_ms)
            up_nnz = float(shard_nnz.mean())
            up = float(cost.upload_payload_bytes(up_nnz, total))
            down = float(cost.payload_bytes(down_nnz, total))
            up_bytes = float(np.sum(cost.upload_payload_bytes(shard_nnz, total)))
            down_bytes = down
            rec.update(upload_mb_per_shard=up / 1e6, broadcast_mb=down / 1e6,
                       dense_mb=total * 4 / 1e6,
                       upload_nnz=[int(x) for x in shard_nnz], download_nnz=int(down_nnz))  # repro-noqa: REP004 (host values)
        history.append(rec)
        if args.obs:  # every rank: the health block's norms span the ranks' rows
            rec_obs.event("round", round=step, wall_ms=step_ms,
                          upload_bytes=up_bytes, download_bytes=down_bytes,
                          loss=rec["loss"])
            obs.health.record_round_health(
                rec_obs, round_idx=step, cstates=state.cstate,
                sstate=state.sstate, bcast=state.gbar,
                upload_nnz_mean=up_nnz, total_params=total_static,
                target_rate=0.0 if args.grad_sync == "dense" else ccfg.rate,
                spans=health_spans)
        if step % args.log_every == 0 or step == args.steps - 1:
            extra = (f" up/shard={rec['upload_mb_per_shard']:.2f}MB "
                     f"bcast={rec['broadcast_mb']:.2f}MB vs dense={rec['dense_mb']:.2f}MB"
                     if "upload_mb_per_shard" in rec else "")
            say(f"[{step:5d}] loss={rec['loss']:.4f}{extra}", flush=True)

    dt = time.time() - t_start
    steady = float(np.mean(steady_ms)) if steady_ms else 0.0
    say(f"{args.steps} steps in {dt:.1f}s "
        f"(first step {first_s:.1f}s + steady {steady:.0f} ms/step)")
    rec_obs.event("summary", steps=args.steps, wall_s=dt,
                  compile_s=first_s, steady_step_ms_mean=steady)
    if args.checkpoint:
        params = state.params
        if mesh is not None:  # the whole params (a collective)
            params = shr.full_tree(params, shr.named_shardings(mesh, shr.param_specs(
                transformer.abstract_params(cfg), fsdp=dstep.needs_fsdp(cfg), mesh=mesh)))
        if _rank0():
            save_ckpt(args.checkpoint, params, step=args.steps)
            print(f"checkpoint -> {args.checkpoint}.npz")
    return _write_and_judge(args, history)


if __name__ == "__main__":
    raise SystemExit(main())
