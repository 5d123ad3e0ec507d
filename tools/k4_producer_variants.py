#!/usr/bin/env python3
"""Compare the two producer designs of K4's tensor-core kernel at head dim
256 on one GPU.

    python3 tools/k4_producer_variants.py [--reps 20]

``csrc/flash_attention_sm90.cu`` runs D 256 with a producer warpgroup that
hands its registers to the two consumer warpgroups (``setmaxnreg``, 384
threads, 240 registers a consumer thread: ``WIDE_PRODUCER``). The other
design is the one the smaller head dims use, a single producer warp (288
threads: 9 warps put 3 on one of the SM's four 16,384-register quarters,
so at most 168 registers a thread). This script builds the source as
committed and a copy with ``WIDE_PRODUCER`` false, both into
``build/torch_kernels/``, prints the compiler's registers and spill bytes
for ``flash_fwd_sm90<256>`` of each, holds both against the plain version
(``kernels/ref.py``) within chip_smoke.py's bf16 bounds, and times both at
recurrentgemma-9b's prefill shape (B 4, T 2048, H 16, KV 1, bf16, causal),
in turns (wide, narrow, narrow, wide; CUDA events around one call, the
median of ``--reps`` after 3 warm-ups, the better of the two medians).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WIDE = "static constexpr bool WIDE_PRODUCER = D == 256;"
SHAPE = (4, 2048, 16, 1, 256)  # B, T, H, KV, D: recurrentgemma-9b's prefill
HELD = [(2, 1000, 16, 2, 256, True), (2, 1000, 16, 2, 256, False), SHAPE + (True,)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as k4

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=False)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    source = k4.TC_SOURCE.read_text()
    if WIDE not in source:
        sys.exit(f"{k4.TC_SOURCE} no longer holds the line {WIDE!r}")
    narrow = build.BUILD_ROOT / "variants" / k4.TC_SOURCE.name
    narrow.parent.mkdir(parents=True, exist_ok=True)
    narrow.write_text(source.replace(WIDE, "static constexpr bool WIDE_PRODUCER = false;"))
    libs = {}
    for name, path in (("wide", k4.build_tc()), ("narrow", build.build_library(narrow,
                                                                               k4.NVCC_FLAGS))):
        report = build.ptxas_report((path.parent / "build.log").read_text(), "flash_fwd_sm90")
        print(f"{name}: flash_fwd_sm90<256> {json.dumps(report.get(256))}", flush=True)
        libs[name] = build.bind(ctypes.CDLL(str(path)), k4.TC_SIGNATURES)

    def run(lib, q, k, v, causal=True):
        o = torch.empty_like(q)
        b, t, h, d = q.shape
        strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *o.stride()[:3])
        err = lib.flash_attention_sm90_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), d, b, h, k.shape[2], t,
            k.shape[1], strides, d**-0.5 * 1.4426950408889634, int(causal),
            torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"launch failed with cudaError_t {err}")
        return o

    def inputs(seed, b, t, h, kv, d):
        rng = np.random.default_rng(seed)
        return tuple(torch.tensor(rng.normal(size=(b, t, n, d)).astype(np.float32),
                                  device="cuda").to(torch.bfloat16) for n in (h, kv, kv))

    for i, (b, t, h, kv, d, causal) in enumerate(HELD):
        q, k, v = inputs(i, b, t, h, kv, d)
        want = ref.flash_attention(q, k, v, causal=causal).float()
        for name, lib in libs.items():
            diff = run(lib, q, k, v, causal).float() - want
            err, rel = diff.abs().max().item(), (diff.norm() / want.norm()).item()
            bad = (diff.abs() > 3e-2 + 3e-2 * want.abs()).sum().item()
            print(f"{name} at B {b} T {t} H {h} KV {kv} D {d} causal={causal}: max abs "
                  f"{err:.3e}, relative L2 {rel:.3e}", flush=True)
            if bad or not rel <= 5e-4:
                sys.exit(f"{name} differs from the plain version: {bad} elements beyond "
                         f"3e-2, relative L2 {rel:.3e} (bound 5e-4)")

    def timed(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(args.reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    b, t, h, kv, d = SHAPE
    q, k, v = inputs(9, *SHAPE)
    ms = {name: [] for name in libs}
    for name in ("wide", "narrow", "narrow", "wide"):
        ms[name].append(timed(lambda: run(libs[name], q, k, v)))
    flops = 4 * b * h * d * (t * (t + 1) // 2)
    print("at B 4 T 2048 H 16 KV 1 D 256 bf16 causal: " + ", ".join(
        f"{name} {min(x):.4f} ms ({flops / min(x) / 1e9:.1f} TFLOP/s; medians "
        f"{', '.join(f'{y:.4f}' for y in x)})" for name, x in ms.items()), flush=True)


if __name__ == "__main__":
    main()
