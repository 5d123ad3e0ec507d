#!/usr/bin/env python3
"""Time ``gmf_select`` at several tile lengths over the stacks its paths
give it, on one GPU.

    python3 tools/torch_select_tiles.py [--tiles 16384,40960,65536,0,-1] [--skip-llama]
                                        [--variants]

``gmf_select`` (``src/repro_torch/kernels/csrc/gmf_compress.cu``) selects
a segment of at most one tile in one block and splits a larger one over
its tiles (``kernels/gmf_compress.py:plan_select``); ``select_tile`` gives
a layout the tile length the port uses (tile -1 here). Tile 0 stands for one
tile as long as the largest leaf: every segment in one block, the design
before the split. For
each case (llama3.2-1b's bf16 row in both modes, a ResNet-56 round's fused
select, a Shakespeare round's |z| select with a per-row keep table, the
top-k downlink's ResNet-56 broadcast), at each tile length, the kernel is
held against its plain version (``kernels/ref.py``, ``core/sparsify.py``):
thresholds and |z| masks bitwise, inverse norms within 1e-6 relative, two
runs bitwise; then timed with CUDA events around the wrapper call (the
median of ``--reps`` after a warm-up; one run where a call takes more than
a second) and by its kernel's device time in a ``torch.profiler`` trace,
beside the plain version's time and the bytes bound (v and m
read once; z read and the mask written once). Inputs are normal draws
rounded to 1/16, so many scores tie. The last line is a JSON object of
every time; it is also written to ``chiprun_out/select_tiles.json``.
Under ``--variants`` two patched copies of the source (built under
``build/torch_kernels/variants/``) are held and timed at the layout's own
tile beside the committed build: one whose warps aggregate their counts
(one shared atomic per distinct digit in a warp, by ``__match_any_sync``;
``count_one``'s body replaced; the committed count takes one shared
atomic a candidate), and one that launches cooperatively where no leaf is
split too (``launch_select``'s plain launch of a block a segment taken
out; it changes only the layouts with no split leaf, such as ResNet-56's).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RATE, EPS = 0.1, 1e-16
HBM = {"H100": 3.35e12, "H200": 4.8e12}
# Each variant build: the committed source's line(s) and what it puts there.
VARIANTS = {
    # count_one's body -> one shared atomic per distinct digit in a warp
    "warp-aggregated count": (
        "  if (hit) atomicAdd(&hist[(bits >> shift) & dmask], 1u);\n",
        """  if (!__any_sync(0xffffffffu, hit)) return;
  const unsigned d = (bits >> shift) & dmask;
  const unsigned peers = __match_any_sync(0xffffffffu, hit ? d : 0xffffffffu);
  if (hit && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[d], (unsigned)__popc(peers));
"""),
    # launch_select's plain launch -> the cooperative launch for every layout
    "cooperative launch always": (
        "  if (!plan.n_split) {\n    kernel<<<",
        "  if (false) {\n    kernel<<<"),
}


def timed_ms(fn, reps: int) -> float:
    fn()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def device_ms(fn, calls: int) -> float | None:
    """The device time of the select's kernels a call, from a
    ``torch.profiler`` trace of ``calls`` calls: what the call costs when
    the host has queued it ahead (the CUDA events around one call on an
    idle card also hold the wrapper's host time). A trace that holds no
    select kernel is taken once more; None if the second holds none
    either (the profiler can drop a short trace's device activities)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages() if "select_kernel" in e.key)
        if us > 0:
            return us / calls / 1e3
    return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", default="16384,40960,65536,0",
                    help="tile lengths; 0 is one block a segment, -1 the layout's own "
                         "(select_tile)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--skip-llama", action="store_true")
    ap.add_argument("--variants", action="store_true",
                    help="also time builds with warp-aggregated counts "
                         "(__match_any_sync) and with a cooperative launch for every "
                         "layout, at the layout's own tile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.core import sparsify
    from repro_torch.data.synthetic import VOCAB
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.models import lstm, resnet, transformer
    from repro_torch.utils.flat import FlatLayout

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=False)
    card = smi.stdout.strip()
    kind = torch.cuda.get_device_name(0)
    bw = next((r for k, r in HBM.items() if k in kind), None)
    if bw is None:
        sys.exit(f"no bandwidth figure for {kind!r}")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = {"committed": gk.library()}
    if args.variants:
        source = gk.SOURCE.read_text()
        for i, (name, (old, new)) in enumerate(VARIANTS.items()):
            if source.count(old) != 1:
                sys.exit(f"{gk.SOURCE} no longer holds {old!r} once ({name})")
            patched = build.BUILD_ROOT / "variants" / str(i) / gk.SOURCE.name
            patched.parent.mkdir(parents=True, exist_ok=True)
            patched.write_text(source.replace(old, new))
            libs[name] = build.bind(
                ctypes.CDLL(str(build.build_library(patched, gk.NVCC_FLAGS))), gk.SIGNATURES)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)

    def draw(rows, n, dtype=torch.float32):  # normal, rounded to 1/16
        x = torch.randn(rows, n, generator=gen, device=dev)
        return x.mul_(16).round_().div_(16).to(dtype)

    def layout_of(params):
        lay = FlatLayout.of(params)
        return FlatLayout.of_sizes(lay.sizes, dev)

    cases = []
    if not args.skip_llama:
        params = transformer.init_params(configs.get_config("llama3.2-1b"),
                                         torch.Generator(device=dev).manual_seed(0))
        llama = layout_of(params)
        del params
        cases += [("llama3.2-1b bf16 row, fused", llama, 1, torch.bfloat16, "fused"),
                  ("llama3.2-1b bf16 row, |z|", llama, 1, torch.bfloat16, "abs")]
    res56 = layout_of(resnet.init_resnet(torch.Generator().manual_seed(0), depth=56, device=dev))  # repro-noqa: REP001 (only the sizes are used)
    shakes = layout_of(lstm.init_lstm(torch.Generator().manual_seed(0), vocab=VOCAB, device=dev))  # repro-noqa: REP001 (only the sizes are used)
    cases += [("ResNet-56 round (20 clients), fused", res56, 20, torch.float32, "fused"),
              ("Shakespeare round (10 clients), |z|, per-row keep table", shakes, 10,
               torch.float32, "abs_rows"),
              ("ResNet-56 broadcast (top-k downlink), |z|", res56, 1, torch.float32, "abs")]
    runs = [(int(t), "committed") for t in args.tiles.split(",")]
    runs += [(-1, name) for name in libs if name != "committed"]
    out = {"card": card}
    for label, layout, rows, dtype, mode in cases:
        v, m = draw(rows, layout.total, dtype), draw(rows, layout.total, dtype)
        w = torch.ones(rows, device=dev)
        tau = torch.full((rows,), 0.3, device=dev)
        keep = (sparsify.keep_table(layout, torch.full((rows,), RATE, device=dev))
                if mode == "abs_rows" else layout.keep(RATE)[1])
        elems = rows * layout.total
        if mode == "fused":
            plain = lambda: ref.gmf_select(v, m, layout, RATE, w=w, tau=tau, eps=EPS)
            nbytes = 2 * v.element_size() * elems
        elif mode == "abs":
            plain = lambda: sparsify.segment_topk_mask(v, layout, RATE)
            nbytes = (v.element_size() + 4) * elems
        else:
            plain = lambda: sparsify.segment_topk_mask_keep(v, layout, keep)
            nbytes = (v.element_size() + 4) * elems
        slow = layout.total > 10**8
        want = plain()
        plain_ms = timed_ms(plain, 1 if slow else args.reps)
        row = {"at": f"[{rows}, {layout.total}], {layout.num_leaves} leaves, {dtype}",
               "plain_ms": plain_ms, "bound_ms": nbytes / bw * 1e3, "tiles": {}}
        ref_scalars, ref_thr = None, None
        for tile, lib in runs:
            gk.library = lambda lib=lib: libs[lib]
            plan = (layout.select_plan() if tile < 0 else
                    gk.select_table(gk.plan_select(layout.sizes, tile or max(layout.sizes)),
                                    dev))
            if mode == "fused":
                run = lambda: gk.gmf_select_flat(v, m, offsets=layout.offsets_dev, plan=plan,
                                                 keep=keep, w=w, tau=tau, eps=EPS)
            else:
                run = lambda: gk.topk_abs_select_flat(v, offsets=layout.offsets_dev, plan=plan,
                                                      keep=keep)
            got, again = run(), run()
            torch.cuda.synchronize()
            for a, b in zip(got, again, strict=True):
                if not torch.equal(a, b):
                    sys.exit(f"FAIL: {label}, tile {tile}: two runs differ")
            if mode == "fused":
                for a, b in zip(got[:2], want[:2], strict=True):
                    rel = ((a - b).abs() / b.abs()).max().item()
                    if rel > 1e-6:
                        sys.exit(f"FAIL: {label}, tile {tile}: inverse norms {rel:.3e} relative")
                if ref_scalars is None or not all(torch.equal(a, b) for a, b in
                                                  zip(got[:2], ref_scalars, strict=True)):
                    z = ref.gmf_fusion_score(v, m, inv_norm_v=layout.expand(got[0]),
                                             inv_norm_m=layout.expand(got[1]), tau=tau)
                    ref_scalars = got[:2]
                    ref_thr = sparsify.segment_thresholds(z, layout, RATE)
                    del z
                ok = torch.equal(got[2], ref_thr)
            else:
                ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            if not ok:
                sys.exit(f"FAIL: {label}, tile {tile}: threshold or mask differs from the plain "
                         f"version's")
            del got, again
            ms = timed_ms(run, 1 if slow and tile == 0 else (5 if slow else args.reps))
            key = (f"{plan.plan.tile} (select_tile)" if tile < 0 else str(tile) if tile
                   else "one block a segment")
            key += "" if lib == "committed" else f", {lib}"
            dev_ms = device_ms(run, 1 if slow and tile == 0 else 10)
            row["tiles"][key] = {"ms": ms, "device_ms": dev_ms,
                                 "blocks": plan.n_tiles + plan.n_local,
                                 "split_leaves": plan.n_split}
            print(f"  {label} {row['at']}, tile {key}: {ms:.4f} ms, device "
                  f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'} "
                  f"({plan.n_split} leaves split over {plan.n_tiles} tiles, {plan.n_local} "
                  f"whole), plain {plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms; held "
                  f"bitwise", flush=True)
        out[label] = row
        del v, m, want
        torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "select_tiles.json").write_text(json.dumps(out, indent=1))
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
