#!/usr/bin/env python3
"""Where a decode step of granite-moe-1b-a400m through the expert-parallel
MoE (``moe.moe_ep`` over a one-rank mesh) spends its time on one GPU,
beside the same step with dense dispatch (no mesh).

    python3 tools/torch_moe_ep_profile.py [--layers 12] [--steps 3]

granite-moe at its published widths, ``--layers`` of 24 (phase 13's cut
by default), bf16, random params from seed 0, a batch of 4 prompts of
2048 tokens prefilled into a cache of 2064. For each of EP and dense
dispatch: 3 warm-up decode steps; one decode step and one prefill under
``torch.cuda.set_sync_debug_mode("warn")`` (the synchronising operations
it reports, by message); ms a step over 5 decode steps (host clock to a
synchronize); then ``--steps`` decode steps under ``torch.profiler``
(CPU and CUDA): the host time a step (the operators' own CPU time), the
device time a step (the kernels' and copies'), the kernel launches a step,
and the operators with the most host and device time. The world is
one rank from a ``file://`` store in the ignored ``build/mesh``, NCCL for
the card's tensors.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-1b-a400m"
BATCH, PROMPT, GEN = 4, 2048, 16


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3, help="profiled decode steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.configs as configs
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with ThreadPoolExecutor(max_workers=3) as pool:  # one nvcc per source, at once
        list(pool.map(lambda make: make(), (gk.build, k4.build, k4.build_tc)))
    store = ROOT / "build" / "mesh" / "profile_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = dataclasses.replace(configs.get_config(ARCH), num_layers=args.layers)
        params = serve.init_params(cfg, 0, dev)
        batch = serve.prompt_batch(cfg, 0, BATCH, PROMPT, dev)
        for label, m in (("ep", mesh), ("dense", None)):
            profile_one(label, dstep, cfg, params, batch, m, dev, args.steps)
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def profile_one(label, dstep, cfg, params, batch, mesh, dev, steps) -> None:
    from torch.profiler import ProfilerActivity, profile

    prefill = dstep.make_prefill_step(cfg, mesh, cache_len=PROMPT + GEN)
    serve_step = dstep.make_serve_step(cfg, mesh)
    logits, cache = prefill(params, batch)
    tok = torch.argmax(logits, -1)
    pos = torch.full((), PROMPT, dtype=torch.int64, device=dev)

    def decode(n):
        nonlocal tok, cache, pos
        for _ in range(n):
            tok, _, cache = serve_step(params, cache, tok, pos)
            pos = pos + 1

    decode(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        decode(1)
        prefill(params, batch)
    torch.cuda.set_sync_debug_mode(0)
    syncs = collections.Counter(str(w.message).splitlines()[0][:160] for w in caught
                                if "Synchronization debug mode" not in str(w.message))
    print(f"[{label}] synchronising ops in one decode step and one prefill: {dict(syncs)}",
          flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode(5)
    torch.cuda.synchronize()
    print(f"[{label}] {(time.perf_counter() - t0) / 5 * 1e3:.3f} ms a decode step (5 steps)",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode(steps)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    on_card = [e.device_type == torch.autograd.DeviceType.CUDA for e in ka]
    host_us = sum(e.self_cpu_time_total for e, card in zip(ka, on_card, strict=True)
                  if not card)
    device_us = sum(e.self_device_time_total for e, card in zip(ka, on_card, strict=True)
                    if card)
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    print(f"[{label}] profiled {steps} steps: host {host_us / steps / 1e3:.3f} ms a step, "
          f"device {device_us / steps / 1e3:.3f} ms a step, {launches / steps:.0f} kernel "
          f"launches a step", flush=True)
    print(ka.table(sort_by="self_cuda_time_total", row_limit=12, max_name_column_width=60))
    print(ka.table(sort_by="cpu_time_total", row_limit=16, max_name_column_width=60),
          flush=True)


if __name__ == "__main__":
    main()
