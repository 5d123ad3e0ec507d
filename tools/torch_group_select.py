#!/usr/bin/env python3
"""Time ``gmf_select``'s group mode at a group of one, step by step, on one
GPU.

    python3 tools/torch_group_select.py [--src DIR] [--variants] [--skip-llama]
                                        [--reps N] [--json PATH]

The group mode (``src/repro_torch/kernels/csrc/gmf_compress.cu``) runs a
select whose segments are cut over a group of ranks as a chain of
launches with an ``all_reduce`` between them. Here every segment of a
layout counts as cut (as in ``chip_smoke.py`` phase 18 (a)) and the group
is one rank over NCCL, so the kernels' own time shows. Cases: llama3.2-1b's
bf16 row ``[1, 1,498,482,688]`` (normal draws rounded to 1/16) and a
ResNet-56 round's float32 stacks ``[20, 855,578]``, each in the fused and
the |z| mode. For each build, each case is held bitwise against the single
launch (thresholds, inverse norms, the |z| mask) and timed: CUDA events
around the wrapper call with the group's all-reduces (``ms``, the median
of ``--reps``), the device's time of calls in a row with no group
(``device_ms``), the host's time to issue one (``host_ms``), and each
step's device time (``steps_ms``, keyed "step/pass"); where the package
reports them, the paths its passes 1 and 2 took (``group_select_paths``).

``--src`` imports ``repro_torch`` from another tree (say a ``git
archive`` of the parent commit under ``build/archive/``), whose own build
directory then holds its kernels: run it and this tree in one call to
compare two commits on one card. ``--variants`` also builds patched copies
of the source (under ``build/torch_kernels/variants/``) and times them
beside the committed build; a variant marked diagnostic leaves out part of
the work to show its cost, and is timed but not held. The registers and
spills of the group kernels of every build are printed from its
``build.log``. The last line is a JSON object of every number; ``--json``
writes it to a file too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
RATE, EPS = 0.1, 1e-16
HBM = {"H100": 3.35e12, "H200": 4.8e12}
GROUP_KERNELS = ("group_first_kernel", "group_sample_kernel", "group_pass0_kernel",
                 "group_pass_kernel", "group_last_kernel")
# Each variant: the committed source's text, what it puts there, and
# whether its results are held (a diagnostic one drops work).
VARIANTS = {
    "pass 0 without its appends (diagnostic)": (
        "    append_hits<N>(b, ok, lo, width, slots, cap, cands);\n", "", False),
    "pass 0 at four quads a thread": (
        "constexpr int kAppendUnroll = 2;", "constexpr int kAppendUnroll = 4;", True),
    "pass 0 without its bound of six blocks an SM": (
        "__launch_bounds__(kSelThreads, 6)\ngroup_pass0_kernel(",
        "__launch_bounds__(kSelThreads)\ngroup_pass0_kernel(", True),
    "passes 1 and 2 a block a tile": (
        "constexpr int kChunkBlocksPerSM = 16;", "constexpr int kChunkBlocksPerSM = 1 << 20;",
        True),
    "passes 1 and 2 at 32 blocks an SM": (
        "constexpr int kChunkBlocksPerSM = 16;", "constexpr int kChunkBlocksPerSM = 32;", True),
    "pass 0 at eight blocks an SM": (
        "__launch_bounds__(kSelThreads, 6)\ngroup_pass0_kernel(",
        "__launch_bounds__(kSelThreads, 8)\ngroup_pass0_kernel(", True),
    "pass 0 at one quad a thread": (
        "constexpr int kAppendUnroll = 2;", "constexpr int kAppendUnroll = 1;", True),
    "the last step at eight blocks an SM": (
        "__launch_bounds__(kSelThreads)\ngroup_last_kernel(",
        "__launch_bounds__(kSelThreads, 8)\ngroup_last_kernel(", True),
}


def registers(log: str) -> dict:
    """{kernel instance: "registers / spill bytes"} of the group kernels in
    a ``build.log`` (``-Xptxas -v``)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in GROUP_KERNELS if k in line), None)
            if name:
                tag = "bf16" if "bfloat16" in line else "f32"
                name = f"{name}<{'abs' if 'ILb1E' in line else 'fused'},{tag}>"
        elif name and "Used" in line and "registers" in line:
            out[name] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif name and "spill stores" in line:
            spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
            if spills:
                out[name + " spill bytes"] = spills
    return out


def timed_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_ms(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return out


def steps_ms(gk, op_name: str, call, reps: int) -> dict:
    """Each step's device ms (median over ``reps`` calls): CUDA events
    around each launch of ``gk.op_name`` that ``call()`` makes."""
    real, marks = getattr(gk, op_name), []

    def timed(step, p, *a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        real(step, p, *a)
        end.record()
        marks.append((f"{step}/{p}", start, end))

    call()
    setattr(gk, op_name, timed)
    try:
        for _ in range(reps):
            call()
    finally:
        setattr(gk, op_name, real)
    torch.cuda.synchronize()
    by = {}
    for key, start, end in marks:
        by.setdefault(key, []).append(start.elapsed_time(end))
    return {k: statistics.median(x) for k, x in by.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory to import repro_torch from")
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the patched copies in VARIANTS")
    ap.add_argument("--skip-llama", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json", default=None, help="also write the last line's object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.models import resnet, transformer
    from repro_torch.utils import tree_leaves
    from repro_torch.utils.flat import FlatLayout

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=False)
    card = smi.stdout.strip()
    kind = torch.cuda.get_device_name(0)
    bw = next((r for k, r in HBM.items() if k in kind), None)
    if bw is None:
        sys.exit(f"no bandwidth figure for {kind!r}")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"repro_torch from {args.src}", flush=True)
    t0 = time.perf_counter()
    sources = {"committed": (gk.SOURCE, True)}
    if args.variants:
        text = gk.SOURCE.read_text()
        for i, (name, (old, new, held)) in enumerate(VARIANTS.items()):
            if text.count(old) != 1:
                sys.exit(f"{gk.SOURCE} no longer holds {old!r} once ({name})")
            patched = build.BUILD_ROOT / "variants" / f"group{i}" / gk.SOURCE.name
            patched.parent.mkdir(parents=True, exist_ok=True)
            patched.write_text(text.replace(old, new))
            sources[name] = (patched, held)
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a source, all at once
        paths = dict(zip(sources, pool.map(
            lambda s: build.build_library(s[0], gk.NVCC_FLAGS), sources.values())))
    libs = {name: (build.bind(ctypes.CDLL(str(paths[name])), gk.SIGNATURES), held,
                   paths[name].parent / "build.log")
            for name, (_, held) in sources.items()}
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    regs = {name: registers(log.read_text()) for name, (_, _, log) in libs.items()}
    for name, r in regs.items():
        print(f"  {name}: registers {json.dumps(r)}", flush=True)

    dev = torch.device("cuda", 0)
    store = Path(tempfile.mkdtemp(dir=ROOT / "build")) / "store"
    torch.distributed.init_process_group("cpu:gloo,cuda:nccl", init_method=f"file://{store}",
                                         rank=0, world_size=1)
    group = torch.distributed.group.WORLD
    cases = []
    if not args.skip_llama:
        sizes = [x.numel() for x in tree_leaves(transformer.abstract_params(
            configs.get_config("llama3.2-1b")))]
        cases.append(("llama3.2-1b bf16 row", FlatLayout.of_sizes(sizes, dev), 1,
                      torch.bfloat16, 23))
    rparams = resnet.init_resnet(torch.Generator().manual_seed(0), depth=56, device=dev)
    cases.append(("ResNet-56 round", FlatLayout.of_sizes(FlatLayout.of(rparams).sizes, dev), 20,
                  torch.float32, 31))
    del rparams
    out = {"card": card, "torch": torch.__version__, "src": args.src, "registers": regs,
           "cases": {}}
    for label, layout, rows, dtype, seed in cases:
        n = layout.total
        gen = torch.Generator(device=dev).manual_seed(seed)
        v, m = (torch.randn(rows, n, generator=gen, device=dev).mul_(16).round_().div_(16)
                .to(dtype) for _ in range(2))
        w = torch.ones(rows, device=dev)
        tau = torch.linspace(0.0, 1.0, rows, device=dev) if rows > 1 else torch.full(
            (1,), 0.3, device=dev)
        keep = layout.keep(RATE)[1]
        offs, one = layout.offsets_dev, layout.select_plan()
        grp = gk.select_table(gk.plan_select(layout.sizes, gk.select_tile(layout.sizes)), dev,
                              group=[True] * layout.num_leaves)
        kw = dict(offsets=offs, keep=keep, w=w, tau=tau, eps=EPS)
        single = gk.gmf_select_flat(v, m, plan=one, **kw)
        single_abs = gk.topk_abs_select_flat(v, offsets=offs, plan=one, keep=keep)
        elt = v.element_size()
        bound = {"fused": 2 * elt * rows * n / bw * 1e3, "abs": (elt + 4) * rows * n / bw * 1e3}
        row = {"at": f"[{rows}, {n}] {dtype}", "bound_ms": bound, "builds": {}}
        for name, (lib, held, _) in libs.items():
            gk.library = lambda lib=lib: lib
            rec = {}
            for mode, op_name in (("fused", "_select_group_op"),
                                  ("abs", "_select_abs_group_op")):
                if mode == "fused":
                    call = lambda g: gk.gmf_select_flat(v, m, plan=grp, group=g, **kw)  # noqa: E731
                    want = single
                else:
                    call = lambda g: gk.topk_abs_select_flat(  # noqa: E731
                        v, offsets=offs, plan=grp, keep=keep, group=g)
                    want = single_abs
                got = call(group)
                same = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
                if held and not same:
                    sys.exit(f"{name}: the group mode's {mode} mode over {label} differs from "
                             f"the single launch")
                del got
                r = {"bitwise": same,
                     "ms": timed_ms(lambda: call(group), args.reps),
                     "device_ms": device_ms(lambda: call(None), args.reps),
                     "host_ms": host_ms(lambda: call(None), args.reps),
                     "steps_ms": steps_ms(gk, op_name, lambda: call(None), 5)}
                if hasattr(gk, "group_select_paths"):
                    call(None)
                    r["paths"] = gk.group_select_paths(grp, rows, dev)
                rec[mode] = r
                print(f"  {label}, {mode}, {name}: ms {r['ms']:.4f} (device "
                      f"{r['device_ms']:.4f}, host {r['host_ms']:.4f}; bound "
                      f"{bound[mode]:.4f}); steps {json.dumps(r['steps_ms'])}"
                      + ("" if same else "; NOT bitwise (diagnostic)"), flush=True)
            row["builds"][name] = rec
        row["single_ms"] = timed_ms(lambda: gk.gmf_select_flat(v, m, plan=one, **kw), args.reps)
        row["abs_single_ms"] = timed_ms(lambda: gk.topk_abs_select_flat(
            v, offsets=offs, plan=one, keep=keep), args.reps)
        print(f"  {label}: single launch {row['single_ms']:.4f}, |z| "
              f"{row['abs_single_ms']:.4f}", flush=True)
        out["cases"][label] = row
        del v, m, single, single_abs
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    store.unlink(missing_ok=True)
    store.parent.rmdir()
    line = json.dumps(out)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
