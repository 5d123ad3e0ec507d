#!/usr/bin/env python3
"""Time the PyTorch port's compression stage on one GPU, at one round of
the paper's ResNet-56 configuration (20 clients, rate 0.1).

    python3 tools/torch_compression_timing.py [--src DIR] [--reps 20]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that a copy of an earlier commit can be
timed in the same call as this one, in turns. Every case calls the
compression on the same numpy-seeded state and gradients, on the host's
clock from the call to a ``torch.cuda.synchronize()`` after it; the median
of ``--reps`` calls after 3 warm-ups is printed, with the kernels' launch
counts per call:

* ``dgcwgmf fused_compress``: score, top-k thresholds, mask and memory
  update of the fused GMF path (``use_kernels=True``), from the updated
  state on;
* ``dgc select + extract``: top-k mask of |V| and the masked extract (K3);
* ``dgcwgmf client_compress`` and ``dgc client_compress``: the whole
  compression stage of a round, momentum correction (K2) included.

The port keeps the compression state as flat ``[k, N]`` client stacks
(``repro_torch.utils.flat``); the commits before that kept a tree of
``[k, ...]`` leaves, which this script times too when the module is
missing, so that both can be compared.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CLIENTS, RATE = 20, 0.1


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import CompressionConfig, resolve, stages
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.models import resnet
    from repro_torch.utils import tree_map

    flat = importlib.util.find_spec("repro_torch.utils.flat") is not None
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=False)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}; src {args.src}; "
          f"flat state: {flat}", flush=True)
    gk.build()

    params = resnet.init_resnet(torch.Generator().manual_seed(0), depth=56, device=dev)
    rng = np.random.default_rng(0)

    def stack():
        return tree_map(lambda p: torch.tensor(
            rng.normal(size=(CLIENTS, *p.shape)).astype(np.float32), device=dev), params)

    u, v, m, grad = stack(), stack(), stack(), stack()
    gbar = tree_map(lambda x: x[0] * 0.1, stack())
    layout_kw, ctx_kw, sel_kw = {}, {}, {}
    if flat:
        from repro_torch.utils.flat import FlatLayout

        layout = FlatLayout.of(params)
        u, v, m, grad = (layout.flatten(t) for t in (u, v, m, grad))
        gbar = layout.flatten(gbar)
        layout_kw = ctx_kw = sel_kw = {"layout": layout}

    def case(scheme, **kw):
        cfg = CompressionConfig(scheme=scheme, rate=RATE, **kw)
        return cfg, resolve(cfg)

    cfg_f, gmf = case("dgcwgmf", tau=0.6, use_kernels=True)
    cfg_d, dgc = case("dgc")
    ctx = stages.StageCtx(round_idx=3, gbar_prev=gbar, local_steps=1.0, mean_steps=1.0,
                          tau_override=None, **ctx_kw)
    ops = stages.elementwise_ops(cfg_d)
    state_f = gmf.init_states(params)[0]._replace(u=u, v=v, m=m)
    state_d = dgc.init_states(params)[0]._replace(u=u, v=v)

    def dgc_select_extract():
        scores, _ = dgc.fusion.scores(cfg_d, v, {}, ctx)
        masks = dgc.selector.select(cfg_d, scores, 3, **sel_kw)
        return dgc.compensator.extract(cfg_d, ops, u, v, v, masks)

    cases = {
        "dgcwgmf fused_compress": lambda: gmf.fusion.fused_compress(cfg_f, u, v, m, ctx),
        "dgc select + extract": dgc_select_extract,
        "dgcwgmf client_compress": lambda: gmf.client_compress(state_f, grad, gbar, 3,
                                                               **layout_kw),
        "dgc client_compress": lambda: dgc.client_compress(state_d, grad, gbar, 3, **layout_kw),
    }
    out = {}
    for name, fn in cases.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        gk.reset_launches()
        fn()
        torch.cuda.synchronize()
        launches = {k: n for k, n in gk.LAUNCHES.items() if n}
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"median_ms": statistics.median(times), "min_ms": min(times),
                     "max_ms": max(times), "launches": launches}
        print(f"  {name}: median {out[name]['median_ms']:.4f} ms (min {min(times):.4f}, "
              f"max {max(times):.4f}) of {args.reps}; launches a call {launches}", flush=True)
    print(json.dumps({"src": args.src, "flat": flat, "card": smi.stdout.strip(),
                      "cases": out}), flush=True)


if __name__ == "__main__":
    main()
