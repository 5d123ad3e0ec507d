#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase (what CI on a GPU runs)
    python3 chip_smoke.py --only kernels   # build + hold the kernels only

Phases, in order; any failure exits nonzero:

1. **Build.** ``nvcc`` compiles ``src/repro_torch/kernels/csrc/gmf_compress.cu``
   and ``csrc/flash_attention.cu`` for ``sm_90a`` into ``build/torch_kernels/``,
   both at once (the compiler's register reports are printed).
2. **Kernels.** Each CUDA kernel (K1 gmf_compress, K2 momentum_correction,
   K3 apply_mask) runs against its plain PyTorch version (``kernels/ref.py``)
   on the card, on numpy-seeded inputs of 1, 5, 1000, 65,537, 3×1001,
   20×36,864 and 2²⁴+3 elements (and one misaligned view), τ ∈ {0, 0.3, 1},
   with inputs rounded to 1/16 so many elements tie exactly at the top-k
   threshold. Masks must be equal and G, U, V bitwise equal: both sides do
   the same float32 operations in the same order with no fused multiply-add.
   K4 flash_attention runs against its plain version in float32 and
   bfloat16, causal and not, G ∈ {1, 4, 8} query heads per kv head (8 is
   MQA at H 8), head dim 16, 32, 64, 128, and T ∈ {1, 64, 1000, 2048} (1000
   is no tile multiple), within atol 3e-5 / rtol 1e-4 in float32 and 3e-2
   in bfloat16 (``tests/test_flash_attention.py``'s tolerances: the two sum
   in other orders), and each output within 1e-5 (float32) or 5e-4
   (bfloat16) relative L2 of the plain version's; the timing phase holds
   K4 to both bounds again at the serving shape.
3. **Path.** ``FLSimulator`` + ``CifarTask(depth=56)`` with 20 clients,
   batch 64, lr 0.1, ``SynthCIFAR(num_train=20000)``: 3 rounds of
   ``dgcwgmf`` (τ 0.6, ``use_kernels=True``) and 3 of ``dgc``. Launch counts
   are reset before each run and read after it: ``dgcwgmf`` must launch K1
   and K2 169 times per round, ``dgc`` K2 and K3. Every client's upload nnz
   must be at least the exact-k sum 85,654; params must stay finite.
4. **Card vs CPU.** Round 0 of ``dgcwgmf`` at depth 8 through the same port
   on the card and with ``device="cpu"``: per-client upload nnz equal, and
   the broadcast within 1e-2 relative L2. Per-element gradients agree to
   ~1e-6 (convolution sums run in another order), so a few elements at a
   top-k boundary can flip; each flip moves the broadcast by one
   threshold-sized entry.
5. **Serving.** ``repro_torch.launch.serve.run_fixed`` on llama3.2-1b at
   full width and depth (16 layers, d_model 2048, bfloat16, random params
   from seed 0 on the card), batch 4, prompt 2048, 32 generated tokens:
   one untimed warm-up run, then the measured one. Counts are reset before
   each run: K4 must launch exactly 16 times (one per layer) and K1–K3
   never; the prefill logits must be finite and every sequence must get 32
   tokens. Then the prefill alone and ``run_fixed``'s decode loop
   (``serve.decode``) alone must launch K4 16 and 0 times.
6. **Serving, card vs CPU.** llama3.2-1b width at depth 2 in float32,
   batch 2, prompt 256, the same params on both devices (K4 on the card,
   naive attention on the CPU): the prefill's last logits and 4 decode
   steps, both sides fed the CPU's greedy tokens, within 1e-4 relative L2
   per step.

TF32 is off for matrix products and convolutions
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set False), so float32 means
float32 on both devices.

The last lines are the card's ``nvidia-smi`` name and power limit, one JSON
line of per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# HBM bandwidth (bytes/s), float32 non-tensor-core peak and bf16 dense
# tensor-core peak (FLOP/s) by card name, from NVIDIA's data sheets.
CARDS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM5 80GB HBM3
    "H200": (4.8e12, 67e12, 989e12),
}

# K-id, kernel name, port source, the Pallas function it replaces, bytes
# per element, float operations per element.
KERNELS = [
    ("K1", "gmf_compress", "src/repro/kernels/gmf_compress.py:101", 28, 10),
    ("K2", "momentum_correction", "src/repro/kernels/gmf_compress.py:64", 20, 3),
    ("K3", "apply_mask", "src/repro/kernels/gmf_compress.py:146", 24, 4),
]
PORT_SOURCE = "src/repro_torch/kernels/csrc/gmf_compress.cu"
RESNET56_LEAVES, RESNET56_PARAMS, RESNET56_KEEP = 169, 855_578, 85_654
K4_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
K4_REPLACES = "src/repro/kernels/flash_attention.py:81"
K4_TOL = {torch.float32: dict(atol=3e-5, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
# Relative L2 of K4 against its plain version over a whole output. The
# elementwise bf16 bound is about half of a typical output element at
# T 2048, so this second bound is what catches a masking or tile-edge error
# there. On an H100 the two summation orders give at most 8.4e-7 (float32)
# and 5.3e-5 (bfloat16) over every held case; the bounds are about 10x that.
K4_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 5e-4}
# The serving run: llama3.2-1b, batch 4, prompt 2048, 32 tokens.
SERVE = dict(batch=4, prompt_len=2048, gen=32)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_rates(name: str):
    for key, rates in CARDS.items():
        if key in name:
            return rates
    fail(f"no bandwidth figure for card {name!r}; add it to CARDS")


def device_us(event) -> float:
    """Self device time (µs) of a ``torch.profiler`` ``key_averages()`` row."""
    return getattr(event, "self_device_time_total", 0) or getattr(
        event, "self_cuda_time_total", 0)


def timed_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` from CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def kernel_inputs(rng, rows, n, dev, misalign=False):
    """u, v, m (or g) of shape [rows, n], rounded to 1/16 so many elements
    tie; ``misalign`` returns views one float past a 16-byte boundary."""

    def one():
        a = np.round(rng.normal(size=rows * n) * 16.0) / 16.0
        t = torch.tensor(a.astype(np.float32), device=dev)
        if misalign:
            buf = torch.empty(rows * n + 1, dtype=torch.float32, device=dev)
            buf[1:] = t
            t = buf[1:]
        return t.reshape(rows, n)

    return one(), one(), one()


def hold_kernels(gk, ref, fusion, sparsify, dev):
    """Every kernel against its plain version on the card; returns the
    largest absolute difference seen per kernel (0 when bitwise)."""
    rng = np.random.default_rng(0)
    cases = [(1, 1, False), (1, 5, False), (1, 1000, False), (1, 65_537, False),
             (3, 1001, False), (20, 36_864, False), (1, 2**24 + 3, False),
             (3, 1001, True)]
    worst = {"gmf_compress": 0.0, "momentum_correction": 0.0, "apply_mask": 0.0}

    def same(name, got, want, what):
        check(got.shape == want.shape, f"{name}: {what} shape {tuple(got.shape)}")
        err = (got - want).abs().max().item() if got.numel() else 0.0
        worst[name] = max(worst[name], err)
        check(torch.equal(got, want), f"{name}: {what} differs from the plain version "
              f"(max abs {err:.3e}) at shape {tuple(got.shape)}")

    for rows, n, mis in cases:
        u, v, m = kernel_inputs(rng, rows, n, dev, mis)
        for alpha in (0.0, 0.9):
            got = gk.momentum_correction_flat(u, v, m, alpha)
            want = ref.momentum_correction_leaf(u, v, m, alpha)
            for what, a, b in zip(("U", "V"), got, want, strict=True):
                same("momentum_correction", a, b, what)
        mask = (torch.tensor(rng.random((rows, n)) > 0.7, device=dev)).float()
        if mis:
            buf = torch.empty(rows * n + 1, dtype=torch.float32, device=dev)
            buf[1:] = mask.reshape(-1)
            mask = buf[1:].reshape(rows, n)
        got = gk.apply_mask_flat(u, v, mask)
        want = ref.apply_mask_update_leaf(u, v, mask)
        for what, a, b in zip(("G", "U", "V"), got, want, strict=True):
            same("apply_mask", a, b, what)
        inv_nv = 1.0 / (fusion.row_l2_norm(v) + 1e-16)
        inv_nm = 1.0 / (fusion.row_l2_norm(m) + 1e-16)
        for tau in (0.0, 0.3, 1.0):
            tau_k = torch.full((rows,), tau, dtype=torch.float32, device=dev)
            z = ref.gmf_fusion_score(v, m, inv_norm_v=inv_nv, inv_norm_m=inv_nm, tau=tau_k)
            thr = sparsify.exact_threshold(z, sparsify.num_keep(n, 0.1)).contiguous()
            ties = int((z == thr[:, None]).sum().item())
            check(ties >= rows, f"gmf_compress: no element sits at the threshold ({rows}x{n})")
            kw = dict(inv_norm_v=inv_nv, inv_norm_m=inv_nm, tau=tau_k, threshold=thr)
            got = gk.gmf_compress_flat(u, v, m, **kw)
            want = ref.gmf_compress_leaf(u, v, m, **kw)
            for what, a, b in zip(("G", "U", "V", "mask"), got, want, strict=True):
                same("gmf_compress", a, b, what)
        print(f"  held {rows}x{n}{' misaligned' if mis else ''}: K1 (τ 0, 0.3, 1), "
              f"K2, K3 bitwise", flush=True)
    torch.cuda.synchronize()
    return worst


def time_kernels(gk, ref, leaf_shapes, clients, bw, peak, dev):
    """Each kernel over one round's launches (every ResNet-56 leaf, all
    clients), its plain version over the same inputs, and the bound."""
    rng = np.random.default_rng(1)
    sets = []
    for shape in leaf_shapes:
        n = math.prod(shape)
        u, v, m = kernel_inputs(rng, clients, n, dev)
        mask = (torch.tensor(rng.random((clients, n)) > 0.9, device=dev)).float()
        thr = torch.full((clients,), 0.01, dtype=torch.float32, device=dev)
        inv = torch.full((clients,), 1e-3, dtype=torch.float32, device=dev)
        tau = torch.full((clients,), 0.6, dtype=torch.float32, device=dev)
        sets.append((u, v, m, mask, dict(inv_norm_v=inv, inv_norm_m=inv, tau=tau,
                                         threshold=thr)))
    elems = clients * sum(math.prod(s) for s in leaf_shapes)
    runs = {
        "gmf_compress": (lambda: [gk.gmf_compress_flat(u, v, m, **kw) for u, v, m, _, kw in sets],
                         lambda: [ref.gmf_compress_leaf(u, v, m, **kw)
                                  for u, v, m, _, kw in sets]),
        "momentum_correction": (
            lambda: [gk.momentum_correction_flat(u, v, m, 0.9) for u, v, m, _, _ in sets],
            lambda: [ref.momentum_correction_leaf(u, v, m, 0.9) for u, v, m, _, _ in sets]),
        "apply_mask": (lambda: [gk.apply_mask_flat(u, v, mk) for u, v, _, mk, _ in sets],
                       lambda: [ref.apply_mask_update_leaf(u, v, mk) for u, v, _, mk, _ in sets]),
    }
    out = {}
    for kid, name, _, bpe, ops in KERNELS:
        kern, plain = runs[name]
        ms = timed_ms(kern)
        plain_ms = timed_ms(plain)
        nbytes = bpe * elems
        bound_bytes = nbytes / bw * 1e3
        bound_ops = ops * elems / peak * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations")
        print(f"  {kid} {name}: {len(sets)} launches, {nbytes / 1e6:.1f} MB, kernel "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
              f"bound {out[name]['bound_ms']:.4f} ms", flush=True)
    # One large launch per kernel: the bandwidth the kernel reaches when the
    # launch overhead is amortised.
    n = 2**24 + 3
    u, v, m = kernel_inputs(rng, 1, n, dev)
    mask = (v.abs() > 1.0).float()
    one = dict(inv_norm_v=torch.full((1,), 1e-3, device=dev),
               inv_norm_m=torch.full((1,), 1e-3, device=dev),
               tau=torch.full((1,), 0.6, device=dev),
               threshold=torch.full((1,), 1e-3, device=dev))
    big = {"gmf_compress": (lambda: gk.gmf_compress_flat(u, v, m, **one),
                            lambda: ref.gmf_compress_leaf(u, v, m, **one)),
           "momentum_correction": (lambda: gk.momentum_correction_flat(u, v, m, 0.9),
                                   lambda: ref.momentum_correction_leaf(u, v, m, 0.9)),
           "apply_mask": (lambda: gk.apply_mask_flat(u, v, mask),
                          lambda: ref.apply_mask_update_leaf(u, v, mask))}
    for kid, name, _, bpe, _ in KERNELS:
        kern, plain = big[name]
        ms, plain_ms = timed_ms(kern), timed_ms(plain)
        print(f"  {kid} {name} at {n} elements: {bpe * n / 1e6:.1f} MB, kernel {ms:.4f} ms "
              f"({bpe * n / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, bound "
              f"{bpe * n / bw * 1e3:.4f} ms", flush=True)
    return out


def k4_err(got, want):
    """(max abs difference, relative L2 difference, count of elements
    beyond K4_TOL) of K4's output against its plain version's."""
    tol = K4_TOL[want.dtype]
    diff, ref_ = got.float() - want.float(), want.float()
    err = diff.abs()
    bad = (err > tol["atol"] + tol["rtol"] * ref_.abs()).sum().item()
    rel = (diff.norm() / ref_.norm()).item()
    return err.max().item(), rel, bad


def check_k4(got, want, what):
    """Fail unless K4's output is within both K4_TOL and K4_REL_L2 of its
    plain version's; returns (max abs, relative L2)."""
    err, rel, bad = k4_err(got, want)
    check(bad == 0, f"K4 differs from its plain version at {what}: {bad} elements beyond "
          f"{K4_TOL[want.dtype]}, max abs {err:.3e}")
    check(math.isfinite(rel) and rel <= K4_REL_L2[want.dtype],
          f"K4 differs from its plain version at {what}: relative L2 {rel:.3e} > "
          f"{K4_REL_L2[want.dtype]}")
    return err, rel


def hold_k4(k4, ref, dev):
    """K4 against its plain version on the card at every listed dtype,
    mask, grouping, head dim and length; returns the largest absolute
    difference seen."""
    rng = np.random.default_rng(4)
    worst, cases = 0.0, 0
    worst_rel = {dtype: 0.0 for dtype in K4_TOL}
    for t in (1, 64, 1000, 2048):
        for d in (16, 32, 64, 128):
            b = 1 if t == 2048 else 2
            q = torch.tensor(rng.normal(size=(b, t, 8, d)).astype(np.float32), device=dev)
            kf = torch.tensor(rng.normal(size=(b, t, 8, d)).astype(np.float32), device=dev)
            vf = torch.tensor(rng.normal(size=(b, t, 8, d)).astype(np.float32), device=dev)
            for g in (1, 4, 8):
                kv = 8 // g
                for dtype in K4_TOL:
                    qq = q.to(dtype)
                    k, v = kf[:, :, :kv].to(dtype), vf[:, :, :kv].to(dtype)
                    for causal in (True, False):
                        got = k4.flash_attention(qq, k, v, causal=causal)
                        want = ref.flash_attention(qq, k, v, causal=causal)
                        check(got.dtype == dtype and got.shape == qq.shape,
                              f"K4: {got.dtype} {tuple(got.shape)}")
                        err, rel = check_k4(got, want, f"B {b} T {t} H 8 KV {kv} D {d} "
                                            f"{dtype} causal={causal}")
                        worst = max(worst, err)
                        worst_rel[dtype] = max(worst_rel[dtype], rel)
                        cases += 1
        print(f"  held K4 at T {t}: D 16/32/64/128 x G 1/4/8 x f32/bf16 x causal/not, "
              f"max abs so far {worst:.3e}", flush=True)
    torch.cuda.synchronize()
    print(f"  K4: {cases} cases within tolerance; largest relative L2 "
          + ", ".join(f"{str(dt).split('.')[-1]} {worst_rel[dt]:.3e} (bound {K4_REL_L2[dt]})"
                      for dt in K4_TOL), flush=True)
    return worst


def time_k4(k4, ref, bw, bf16_peak, dev):
    """K4 at the serving shape (B 4, T 2048, H 32, KV 8, D 64, bf16,
    causal): kernel, plain version, SDPA (timed only), and the bounds."""
    b, t, h, kv, d = 4, 2048, 32, 8, 64
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.normal(size=(b, t, n, d)).astype(np.float32),
                            device=dev).to(torch.bfloat16) for n in (h, kv, kv))
    got = k4.flash_attention(q, k, v)
    want = ref.flash_attention(q, k, v)
    err, rel = check_k4(got, want, "the serving shape")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = (lib.float() - want.float()).abs().max().item()
    ms = timed_ms(lambda: k4.flash_attention(q, k, v))
    plain_ms = timed_ms(lambda: ref.flash_attention(q, k, v))
    library_ms = timed_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = t * (t + 1) // 2  # (query, key) pairs the causal mask keeps
    flops = 4 * b * h * d * pairs  # QK^T and PV, 2 FLOP per multiply-add
    nbytes = 2 * (2 * b * t * h * d + 2 * b * t * kv * d)  # q, o, k, v in bf16
    bound_ops, bound_bytes = flops / bf16_peak * 1e3, nbytes / bw * 1e3
    print(f"  K4 at B {b} T {t} H {h} KV {kv} D {d} bf16 causal: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} "
          f"ms; {flops / 1e9:.2f} GFLOP -> {bound_ops:.4f} ms at {bf16_peak / 1e12:.0f} "
          f"TFLOP/s, {nbytes / 1e6:.1f} MB -> {bound_bytes:.4f} ms; max abs vs plain "
          f"{err:.3e}, relative L2 {rel:.3e} (bound {K4_REL_L2[torch.bfloat16]}), SDPA vs plain "
          f"{lib_err:.3e}; 16 launches per prefill: kernel "
          f"{16 * ms:.3f} ms, bound {16 * max(bound_ops, bound_bytes):.3f} ms", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                library_ms=library_ms)


# ---------------------------------------------------------------------------
# path phases
# ---------------------------------------------------------------------------


def run_path(rt, task, scheme_kw, rounds, clients, batch, launches):
    comp = rt.core.CompressionConfig(rate=0.1, **scheme_kw)
    fl = rt.fl.FLConfig(num_clients=clients, rounds=rounds, batch_size=batch,
                        learning_rate=0.1, eval_every=rounds)
    sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, task.eval_fn,
                            device=task.device)
    rt.gk.reset_launches()
    hist = sim.run(task.batch_provider(batch))
    torch.cuda.synchronize()
    counts = dict(rt.gk.LAUNCHES)
    for name, n in counts.items():
        launches[name] += n
    return sim, hist, counts


def path_phase(rt, dev):
    data = rt.synthetic.SynthCIFAR(num_train=20000)
    task = rt.fl.CifarTask(num_clients=20, depth=56, data=data, device=dev)
    launches = {"gmf_compress": 0, "momentum_correction": 0, "apply_mask": 0}
    expect = {
        "dgcwgmf": ({"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True},
                    {"gmf_compress": 3, "momentum_correction": 3, "apply_mask": 0}),
        "dgc": ({"scheme": "dgc"},
                {"gmf_compress": 0, "momentum_correction": 3, "apply_mask": 3}),
    }
    leaf_shapes = None
    for label, (kw, per_round) in expect.items():
        t0 = time.perf_counter()
        sim, hist, counts = run_path(rt, task, kw, 3, 20, 64, launches)
        leaves = rt.utils.tree_leaves(sim.params)
        leaf_shapes = [tuple(x.shape) for x in leaves]
        check(len(leaves) == RESNET56_LEAVES, f"{len(leaves)} leaves, expected 169")
        check(sim.total_params == RESNET56_PARAMS, f"{sim.total_params} params")
        keep = sum(rt.sparsify.num_keep(math.prod(s), 0.1) for s in leaf_shapes)
        check(keep == RESNET56_KEEP, f"exact-k sum {keep}, expected {RESNET56_KEEP}")
        for rec in hist:
            nnz = rec["upload_nnz"]
            check(len(nnz) == 20 and min(nnz) >= keep,
                  f"{label} round {rec['round']}: upload nnz {nnz} below {keep}")
        check(all(bool(torch.isfinite(x).all()) for x in leaves), f"{label}: params not finite")
        want = {k: v * RESNET56_LEAVES for k, v in per_round.items()}
        check(counts == want, f"{label}: launches {counts}, expected {want}")
        ms = [round(r["round_ms"], 3) for r in hist[1:]]
        print(f"  {label}: launches {counts}; upload nnz per client (round 0) "
              f"{hist[0]['upload_nnz']}; ms/round after round 0 {ms}; ledger "
              f"{json.dumps(sim.ledger.summary())}; accuracy {sim.final_accuracy()}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches, leaf_shapes, task


def profile_phase(rt, task):
    """Where a ResNet-56 round's time goes: the client-gradient share
    (host clock around ``engine._grads`` with a synchronise on each side),
    and a ``torch.profiler`` trace of one steady round with the device's
    busy share and its costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    for label, kw in (("dgcwgmf", {"scheme": "dgcwgmf", "tau": 0.6, "use_kernels": True}),
                      ("dgc", {"scheme": "dgc"})):
        comp = rt.core.CompressionConfig(rate=0.1, **kw)
        fl = rt.fl.FLConfig(num_clients=20, rounds=2, batch_size=64, learning_rate=0.1)
        sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=task.device)
        provide = task.batch_provider(64)
        sim.run(provide)  # warm-up rounds
        batches = provide(0, list(range(20)), np.random.default_rng(0))
        grads_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                sim.engine._grads(sim.params, batches)
            torch.cuda.synchronize()
            grads_ms.append((time.perf_counter() - t0) * 1e3)
        sim.fl.rounds = 3
        t0 = time.perf_counter()
        hist = sim.run(provide)
        round_ms = statistics.median(r["round_ms"] for r in hist[-3:])
        sim.fl.rounds = 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sim.run(provide)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # device-side rows only (kernels, copies, fills): the operator rows
        # carry their kernels' time too and would count it twice
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy = sum(device_us(e) for e in kernels) / 1e3
        launched = sum(e.count for e in kernels)
        top = sorted(kernels, key=device_us, reverse=True)[:12]
        grads = statistics.median(grads_ms)
        print(f"  {label}: round {round_ms:.3f} ms (median of 3), client grads "
              f"{grads:.3f} ms, the rest (compression, aggregation, update) "
              f"{round_ms - grads:.3f} ms; profiled round {wall:.3f} ms with {launched} "
              f"device activities, device busy {busy:.3f} ms "
              f"({100 * busy / wall:.1f} % of the profiled round)", flush=True)
        for e in top:
            print(f"    {device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def card_vs_cpu_phase(rt, dev, tol=1e-2):
    data = rt.synthetic.SynthCIFAR(num_train=2000, num_test=200)
    out = {}
    for device in (dev, "cpu"):
        task = rt.fl.CifarTask(num_clients=8, depth=8, data=data, device=device)
        comp = rt.core.CompressionConfig(scheme="dgcwgmf", rate=0.1, tau=0.6, use_kernels=True)
        fl = rt.fl.FLConfig(num_clients=8, rounds=1, batch_size=32, learning_rate=0.1)
        sim = rt.fl.FLSimulator(fl, comp, task.init_fn, task.loss_fn, device=device)
        hist = sim.run(task.batch_provider(32))
        bcast = torch.cat([x.reshape(-1).cpu() for x in rt.utils.tree_leaves(sim.gbar_prev)])
        out[device if device == "cpu" else "cuda"] = (hist[0]["upload_nnz"], bcast)
    (nnz_g, b_g), (nnz_c, b_c) = out["cuda"], out["cpu"]
    check(nnz_g == nnz_c, f"card vs CPU upload nnz differ: {nnz_g} vs {nnz_c}")
    rel = float((b_g - b_c).norm() / b_c.norm())
    check(math.isfinite(rel) and rel <= tol,
          f"card vs CPU broadcast relative L2 {rel:.3e} > {tol}")
    flips = int(((b_g != 0) != (b_c != 0)).sum())
    print(f"  card vs CPU: upload nnz equal {nnz_g}; broadcast relative L2 {rel:.3e} "
          f"(tolerance {tol}); support flips {flips}", flush=True)


def serve_phase(rt, dev, profile=False):
    """The port's fixed-batch serving path at llama3.2-1b full size; with
    ``profile``, a ``torch.profiler`` trace of one more run: the device's
    busy share of the prefill and of the decode loop, and their costliest
    kernels."""
    cfg = rt.configs.get_config("llama3.2-1b")
    args = rt.serve.parser().parse_args(
        ["--arch", "llama3.2-1b", "--batch", str(SERVE["batch"]), "--prompt-len",
         str(SERVE["prompt_len"]), "--gen", str(SERVE["gen"])])
    t0 = time.perf_counter()
    params = rt.serve.init_params(cfg, args.seed, dev)
    n = sum(x.numel() for x in rt.utils.tree_leaves(params))
    check(n == cfg.param_count() == 1_498_482_688, f"{n} params")
    torch.cuda.synchronize()
    print(f"  llama3.2-1b: {n} params in {cfg.param_dtype} on the card, initialised in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for label in ("warm-up", "measured"):
        rt.gk.reset_launches()
        rt.k4.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        run = rt.serve.run_fixed(cfg, params, args, dev)
        torch.cuda.synchronize()
        counts = {**rt.gk.LAUNCHES, **rt.k4.LAUNCHES}
        check(counts == {"gmf_compress": 0, "momentum_correction": 0, "apply_mask": 0,
                         "flash_attention": cfg.num_layers}, f"{label}: launches {counts}")
        check(bool(torch.isfinite(run.last_logits).all()), f"{label}: logits not finite")
        check(tuple(run.tokens.shape) == (SERVE["batch"], SERVE["gen"]),
              f"{label}: tokens {tuple(run.tokens.shape)}")
        check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab_size)).all()),
              f"{label}: token ids out of range")
        print(f"  {label}: {json.dumps(run.summary)}; launches {counts}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    # Which part launched K4: the prefill alone, then the decode loop alone.
    parts = serve_parts(rt, cfg, params, args, dev)
    split = []
    for fn in parts:
        rt.k4.reset_launches()
        fn()
        split.append(rt.k4.LAUNCHES["flash_attention"])
    torch.cuda.synchronize()
    check(split == [cfg.num_layers, 0], f"K4 launches: prefill alone {split[0]}, decode "
          f"loop alone {split[1]}; expected {cfg.num_layers} and 0")
    print(f"  K4 launches: prefill alone {split[0]}, decode loop alone {split[1]}", flush=True)
    if profile:
        profile_serving(parts, args)
    return run, counts


def serve_parts(rt, cfg, params, args, dev):
    """``run_fixed``'s two parts as separate calls, through its steps and
    its decode loop (``serve.decode``): (prefill, decode), the second
    continuing from the first's output."""
    batch = rt.serve.prompt_batch(cfg, args.seed, args.batch, args.prompt_len, dev)
    cache_len = args.cache_len or (args.prompt_len + args.gen)  # as run_fixed sets it
    prefill_step = rt.dstep.make_prefill_step(cfg, cache_len=cache_len)
    serve = rt.dstep.make_serve_step(cfg)
    state = {}

    def prefill():
        state["logits"], state["cache"] = prefill_step(params, batch)

    def decode():
        tok = torch.argmax(state["logits"], dim=-1)
        pos = torch.full((), args.prompt_len, dtype=torch.int64, device=dev)
        rt.serve.decode(serve, params, state["cache"], tok, pos, args.gen - 1)

    return prefill, decode


def profile_serving(parts, args):
    from torch.profiler import ProfilerActivity, profile

    for label, fn in zip(("prefill", f"decode ({args.gen - 1} steps)"), parts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        busy = sum(device_us(e) for e in kernels) / 1e3
        print(f"  profiled {label}: {wall:.3f} ms wall, {sum(e.count for e in kernels)} "
              f"device activities, device busy {busy:.3f} ms ({100 * busy / wall:.1f} %)",
              flush=True)
        for e in sorted(kernels, key=device_us, reverse=True)[:10]:
            print(f"    {device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")


def serve_card_vs_cpu_phase(rt, dev, tol=1e-4, steps=4):
    """llama3.2-1b width at depth 2, float32, the same params on the card
    (K4 prefill) and the CPU (naive prefill)."""
    import dataclasses

    cfg = dataclasses.replace(rt.configs.get_config("llama3.2-1b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    b, prompt = 2, 256
    params = {"cuda": rt.serve.init_params(cfg, 1, dev)}
    params["cpu"] = rt.utils.tree_map(lambda x: x.cpu(), params["cuda"])
    out = {}
    rt.k4.reset_launches()
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        batch = rt.serve.prompt_batch(cfg, 1, b, prompt, device)
        prefill = rt.dstep.make_prefill_step(cfg, cache_len=prompt + steps)
        out[name] = prefill(params[name], batch)
    check(rt.k4.LAUNCHES["flash_attention"] == cfg.num_layers,
          f"card prefill launched K4 {rt.k4.LAUNCHES['flash_attention']} times")
    serve = rt.dstep.make_serve_step(cfg)
    (lg, cache_g), (lc, cache_c) = out["cuda"], out["cpu"]
    errs = []
    for i in range(steps + 1):
        lg, lc = lg.float().cpu(), lc.float()
        rel = float((lg - lc).norm() / lc.norm())
        errs.append(rel)
        check(math.isfinite(rel) and rel <= tol,
              f"card vs CPU serving: step {i} logits relative L2 {rel:.3e} > {tol}")
        if i == steps:
            break
        tok = torch.argmax(lc, dim=-1)  # the CPU's greedy tokens feed both sides
        pos = torch.tensor(prompt + i)
        _, lg, cache_g = serve(params["cuda"], cache_g, tok.to(dev), pos.to(dev))
        _, lc, cache_c = serve(params["cpu"], cache_c, tok, pos)
    print(f"  card (K4) vs CPU (naive), llama3.2-1b width, 2 layers, float32, batch {b}, "
          f"prompt {prompt}: logits relative L2 prefill {errs[0]:.3e}, decode steps "
          f"{', '.join(f'{e:.3e}' for e in errs[1:])} (tolerance {tol})", flush=True)


# ---------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("kernels",), default=None,
                    help="run only the build and kernel phases")
    ap.add_argument("--profile", action="store_true",
                    help="also break down where a ResNet-56 round's and a serving "
                         "run's time goes (torch.profiler)")
    args = ap.parse_args()
    if not all((SRC / "repro_torch" / "kernels" / "csrc" / f).is_file()
               for f in ("gmf_compress.cu", "flash_attention.cu")):
        fail(f"{SRC / 'repro_torch'} is missing: run this script from a checkout of the repo")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    import repro_torch.configs as configs
    import repro_torch.core as core
    import repro_torch.fl as fl
    import repro_torch.utils as utils
    from repro_torch.core import fusion, sparsify
    from repro_torch.data import synthetic
    from repro_torch.dist import step as dstep
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.kernels import ref
    from repro_torch.launch import serve

    rt = argparse.Namespace(core=core, fl=fl, utils=utils, gk=gk, k4=k4, synthetic=synthetic,
                            sparsify=sparsify, configs=configs, dstep=dstep, serve=serve)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=False)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip()
    kind = torch.cuda.get_device_name(0)
    bw, peak, bf16_peak = card_rates(kind)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}; "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    print("phase 1: build", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:  # one nvcc per source, at once
        libs = list(pool.map(lambda m: m.build(), (gk, k4)))
    gk.library()
    k4.library()
    for lib in libs:
        log = (lib.parent / "build.log").read_text()
        print(f"  {lib.relative_to(ROOT)}:\n  " + "\n  ".join(
            ln for ln in log.splitlines() if "ptxas" in ln or "error" in ln))
    print(f"  built both in {time.perf_counter() - t0:.1f} s", flush=True)

    print("phase 2: kernels vs plain versions", flush=True)
    worst = hold_kernels(gk, ref, fusion, sparsify, dev)
    worst["flash_attention"] = hold_k4(k4, ref, dev)
    print(json.dumps({"kernels_held": ["K1", "K2", "K3", "K4"]}), flush=True)

    launches = {name: 0 for _, name, _, _, _ in KERNELS}
    launches["flash_attention"] = 0
    if args.only == "kernels":
        leaf_shapes = [tuple(s) for s in _resnet56_leaf_shapes()]
    else:
        print("phase 3: ResNet-56 FL path, 20 clients, batch 64", flush=True)
        launches, leaf_shapes, task = path_phase(rt, dev)
        print("phase 4: card vs CPU, round 0 at depth 8", flush=True)
        card_vs_cpu_phase(rt, dev)
        if args.profile:
            print("profile: where a ResNet-56 round's time goes", flush=True)
            profile_phase(rt, task)
        del task
        print("phase 5: serving llama3.2-1b, batch 4, prompt 2048, 32 tokens", flush=True)
        _, counts = serve_phase(rt, dev, args.profile)
        launches["flash_attention"] = counts["flash_attention"]
        print("phase 6: serving, card vs CPU, llama3.2-1b width at depth 2", flush=True)
        serve_card_vs_cpu_phase(rt, dev)

    print("timing: one round of launches at the ResNet-56 leaf shapes, 20 clients", flush=True)
    times = time_kernels(gk, ref, leaf_shapes, 20, bw, peak, dev)
    print("timing: K4 at the serving shape", flush=True)
    k4_times = time_k4(k4, ref, bw, bf16_peak, dev)
    torch.cuda.synchronize()

    rows = []
    for kid, name, replaces, _, _ in KERNELS:
        rows.append({"name": name, "id": kid, "route": "cuda", "source": PORT_SOURCE,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": worst[name], **times[name], "library_ms": None})
    rows.append({"name": "flash_attention", "id": "K4", "route": "cuda", "source": K4_SOURCE,
                 "replaces": K4_REPLACES, "launches": launches["flash_attention"],
                 "max_abs_err": worst["flash_attention"], **k4_times})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


def _resnet56_leaf_shapes():
    from repro_torch.models import resnet
    from repro_torch.utils import tree_leaves

    params = resnet.init_resnet(torch.Generator().manual_seed(0), depth=56)
    return [x.shape for x in tree_leaves(params)]


if __name__ == "__main__":
    main()
