"""Serving entry point: the port of the reference's ``launch/serve.py``:
fixed-batch decode (prompts, a prefill that builds the ring KV cache,
greedy decode steps) or the continuous-batching engine over the paged KV
pool (``--mode engine``, dense and moe families), one JSON summary line.

    python -m repro_torch.launch.serve --arch llama3.2-1b --batch 4 \
        --prompt-len 2048 --gen 32                      # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke --device cpu --batch 2 --prompt-len 32 --gen 8
    python -m repro_torch.launch.serve --arch llama3.2-1b --mode engine \
        --requests 8 --prompt-len 2048 --gen 32 --stagger 2 --max-slots 4 \
        --pages-per-slot 130 --wire int8 --warmup       # on the GPU

Every architecture of ``configs.ARCH_IDS`` is served: the audio family
greedily decodes every codebook (prompts and tokens (B, K, T)), the vlm
family prepends ``num_patches`` patch embeddings to the prompt and
decodes from position prompt_len + num_patches.

The model is randomly initialised from ``--seed``, as the reference's is;
the prompts come from the same seed through another stream. On the GPU
the prefill's attention runs the K4 CUDA kernel (``models/attention.py``)
in every family that has attention.

A process started by ``torchrun`` joins that world (NCCL on ``cuda``,
gloo on ``cpu``) and serves over a mesh, ``--mesh-shape`` (the
reference's axes) or the reference's (n // 2, 2): its data axes of size 1
(every rank serves every request), its model axis cutting the params by
the reference's ``_TP_RULES`` and, in engine mode, the paged pool's kv
heads (``sharding.pool_specs``). Every rank computes the same tokens; rank
0 prints.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch llama3.2-1b \
        --mode engine --mesh-shape 1,2 --requests 8 --prompt-len 2048 --gen 32

The last stdout line is the JSON summary with the reference's keys. The
timed prefill and the timed decode loop each hold no host sync and end in
one ``torch.cuda.synchronize()``: the position advances on the device and
the tokens stack there until the clock has stopped. In engine mode the
engine (``serve/engine.py``) reads back only each finished request's
tokens (``--stream`` adds a read per token by design: do not time with
it); its prompts are ``--requests`` rows drawn as ``prompt_batch`` draws
them, so they are fixed mode's prompts for a batch of that size.

``--obs`` turns the telemetry spine on (``repro_torch.obs``): a
``run_start`` event, the run's ``serve_summary`` (fixed mode: its batch as
the requests, and tokens/s, then a ``summary`` event; engine mode: the
reference's fields, after one ``serve_request`` event per request) in
``<--obs-dir>/events.jsonl``, then ``metrics.prom`` and ``summary.json``
beside it. The reference's fixed mode writes no ``serve_summary``, so its
event file fails ``python -m repro.obs.report --strict``; this one passes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.obs as obs
from repro_torch import configs
from repro_torch.dist import sharding as shr
from repro_torch.dist import step as dstep
from repro_torch.models import transformer
from repro_torch.serve import ServeConfig, ServeEngine


class FixedRun(NamedTuple):
    summary: dict               # the reference's JSON summary
    tokens: torch.Tensor        # (B, gen) greedy tokens (audio (B, K, gen)), on the CPU
    last_logits: torch.Tensor   # (B, V) float32 prefill logits (audio (B, K, V)), on the device


def seeds(seed: int) -> tuple[int, int]:
    """Independent (init, prompt) seeds from ``seed``."""
    init, prompt = np.random.SeedSequence(seed).generate_state(2)
    return int(init), int(prompt)


def init_params(cfg, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seeds(seed)[0])
    return transformer.init_params(cfg, gen)


def prompt_batch(cfg, seed: int, b: int, prompt_len: int, device) -> dict:
    """The prompts, drawn on the CPU so every device serves the same ones:
    (B, prompt_len) token ids; audio (B, K, prompt_len), one row per
    codebook; vlm adds ``patch_embeds`` (B, num_patches, d_model), standard
    normal draws from the same generator, which the prefill prepends."""
    gen = torch.Generator().manual_seed(seeds(seed)[1])
    shape = (b, cfg.num_codebooks, prompt_len) if cfg.family == "audio" else (b, prompt_len)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((b, cfg.num_patches, cfg.d_model), generator=gen)
    return {k: x.to(device) for k, x in batch.items()}


def first_decode_pos(cfg, prompt_len: int) -> int:
    """Position of the first generated token: after the prompt, and for
    vlm after the patches prepended to it."""
    return prompt_len + (cfg.num_patches if cfg.family == "vlm" else 0)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def decode(serve, params, cache, tok, pos, steps: int):
    """``steps`` greedy decode steps after token ``tok`` ((B,); audio
    (B, K)) at the device scalar position ``pos``, with no host sync: the
    position advances on the device and the tokens stay there. Returns the
    tokens, ``tok`` first, and the cache."""
    generated = [tok]
    for _ in range(steps):
        tok, _, cache = serve(params, cache, tok, pos)
        pos = pos + 1
        generated.append(tok)
    return generated, cache


def run_fixed(cfg, params, args, device, mesh=None) -> FixedRun:
    """Fixed-batch prefill + decode on ``device`` (where ``params`` lie);
    over ``mesh`` (its data axes of size 1: every rank serves the whole
    batch) the steps carry the mesh: ``params`` are the rank's pieces and a
    model axis over 1 runs the forward tensor-parallel (the logits gathered
    whole), and an MoE config runs the expert-parallel MoE."""
    b = args.batch
    cache_len = args.cache_len or (args.prompt_len + args.gen)
    batch = prompt_batch(cfg, args.seed, b, args.prompt_len, device)
    prefill = dstep.make_prefill_step(cfg, mesh, cache_len=cache_len)
    serve = dstep.make_serve_step(cfg, mesh)

    _sync(device)
    t0 = time.perf_counter()
    last_logits, cache = prefill(params, batch)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(last_logits, dim=-1)

    pos = torch.full((), first_decode_pos(cfg, args.prompt_len), dtype=torch.int64,
                     device=device)
    t0 = time.perf_counter()
    generated, cache = decode(serve, params, cache, tok, pos, args.gen - 1)
    _sync(device)  # the decode loop's one synchronize
    t_decode = time.perf_counter() - t0

    gen = torch.stack(generated, dim=-1).cpu()
    steps = max(args.gen - 1, 1)
    print(f"prefill: {b}x{args.prompt_len} tokens in {t_prefill*1e3:.1f} ms")
    print(f"decode:  {args.gen-1} steps x {b} seqs in {t_decode*1e3:.1f} ms "
          f"({t_decode/steps*1e3:.1f} ms/step)")
    print(f"sample continuations (token ids), first sequence: "
          f"{gen.reshape(b, -1)[0][:16].tolist()} ...")
    if not bool(torch.isfinite(last_logits).all()):
        raise RuntimeError("prefill logits are not finite")
    summary = {
        "mode": "fixed",
        "arch": args.arch,
        "batch": b,
        "prompt_len": args.prompt_len,
        "gen": args.gen,
        "prefill_ms": t_prefill * 1e3,
        "decode_ms": t_decode * 1e3,
        "ms_per_step": t_decode / steps * 1e3,
        "tokens_per_s": (args.gen - 1) * b / t_decode if t_decode > 0 else 0.0,
    }
    return FixedRun(summary, gen, last_logits)


def run_engine(cfg, params, args, mesh=None) -> dict:
    """Continuous-batching engine over the paged cache, on the device of
    ``params`` (over ``mesh``: the rank's pieces, ``ServeEngine``); returns
    the reference's summary."""
    scfg = ServeConfig(
        max_slots=args.max_slots,
        page_size=args.page_size,
        pages_per_slot=args.pages_per_slot,
        prompt_pad=args.prompt_pad or args.prompt_len,
        max_new_tokens=args.gen,
        wire=args.wire,
    )
    if args.warmup:
        # One short run first (the prefill and decode shapes are the timed
        # run's), so the timed run measures serving, not the kernels' build
        # and the libraries' first calls.
        warm = ServeEngine(cfg, params, scfg, mesh=mesh)
        warm.submit(np.zeros((min(4, scfg.prompt_pad),), np.int32), max_new_tokens=2)
        warm.run()
        del warm

    eng = ServeEngine(cfg, params, scfg, mesh=mesh)
    prompts = prompt_batch(cfg, args.seed, args.requests, args.prompt_len, "cpu")["tokens"]
    prompts = prompts.numpy().astype(np.int32)
    for i in range(args.requests):
        eng.submit(prompts[i], arrival_tick=i * args.stagger)

    on_token = None
    if args.stream:
        # Streaming "detok": the models here are randomly initialised, so
        # detokenisation is the identity over token ids.
        def on_token(rid, token):
            print(f"  [req {rid}] {token}")

    completions, metrics = eng.run(on_token=on_token)
    print(f"engine:  {metrics['requests']} requests, wire={args.wire}, "
          f"{metrics['generated_tokens']} tokens in {metrics['wall_s']*1e3:.1f} ms "
          f"({metrics['tokens_per_s']:.1f} tok/s, "
          f"p50 {metrics['latency_p50_s']*1e3:.1f} ms, "
          f"p99 {metrics['latency_p99_s']*1e3:.1f} ms, "
          f"peak {metrics['peak_active_slots']} slots)")
    for c in completions[: min(3, len(completions))]:
        print(f"  req {c.rid}: admitted tick {c.admit_tick}, done tick "
              f"{c.done_tick}, tokens {c.tokens[:8].tolist()} ...")
    return {
        "mode": "engine",
        "arch": args.arch,
        "wire": args.wire,
        "requests": args.requests,
        "prompt_len": args.prompt_len,
        "gen": args.gen,
        "max_slots": args.max_slots,
        "page_size": args.page_size,
        "pages_per_slot": args.pages_per_slot,
        **{k: (float(v) if isinstance(v, float) else int(v))
           for k, v in metrics.items()},
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mode", choices=("fixed", "engine"), default="fixed")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=0, help="0 -> prompt+gen")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    # engine mode
    ap.add_argument("--wire", default="float32",
                    choices=("float32", "float16", "bfloat16", "int8"))
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--stagger", type=int, default=0,
                    help="ticks between request arrivals")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages-per-slot", type=int, default=8)
    ap.add_argument("--prompt-pad", type=int, default=0,
                    help="0 -> prompt-len (must be a page multiple)")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as generated (adds a device read per token)")
    ap.add_argument("--warmup", action="store_true",
                    help="engine mode: one short untimed run first")
    ap.add_argument("--mesh-shape", default=None,
                    help="over a torchrun world: the mesh, e.g. 1,2 (data axes of size 1)")
    ap.add_argument("--obs", action="store_true",
                    help="enable the repro_torch.obs telemetry spine (JSONL events "
                         "+ metrics.prom/summary.json under --obs-dir)")
    ap.add_argument("--obs-dir", default="runs/obs-serve",
                    help="telemetry output directory (with --obs)")
    return ap


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    from repro_torch.launch.train import build_mesh, join_world

    device = join_world(args.device)
    mesh = build_mesh(args, device.type)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get_config(args.arch)
    params = init_params(cfg, args.seed, device)
    if mesh is not None:
        if any(mesh.shape[mesh.mesh_dim_names.index(a)] > 1 for a in shr.dp_axes(mesh)):
            raise SystemExit(f"--mesh-shape {args.mesh_shape}: serving takes data axes of size 1 "
                             f"(every rank serves every request)")
        params = shr.local_tree(params, shr.named_shardings(mesh, shr.param_specs(
            params, fsdp=dstep.needs_fsdp(cfg), mesh=mesh)))
    if dist.is_initialized() and dist.get_rank() != 0:  # rank 0 prints
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            return _serve(args, cfg, params, device, mesh, argv)
    return _serve(args, cfg, params, device, mesh, argv)


def _serve(args, cfg, params, device, mesh, argv):
    if args.obs:
        obs.configure(args.obs_dir)
        obs.get().event("run_start", run=f"serve-{args.arch}", argv=argv, backend="serve",
                        mode=args.mode, wire=args.wire)
    try:
        if args.mode == "engine":
            summary = run_engine(cfg, params, args, mesh)
            obs.get().event("serve_summary",
                            requests=summary["requests"],
                            tokens_per_s=summary["tokens_per_s"],
                            peak_active_slots=summary["peak_active_slots"],
                            peak_pages=summary["peak_pages"],
                            page_pool_occupancy=summary["page_pool_occupancy"])
        else:
            summary = run_fixed(cfg, params, args, device, mesh).summary
            obs.get().event("serve_summary", requests=args.batch,
                            tokens_per_s=summary["tokens_per_s"])
            obs.get().event("summary", **summary)
    finally:
        if args.obs:
            obs.export.write_all(args.obs_dir)
            obs.shutdown()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
