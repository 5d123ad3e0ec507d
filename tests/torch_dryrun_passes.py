"""The fake-tensor passes ``tests/test_torch_dryrun.py`` checks, run in a
process of their own (the fake world is global to a process): a few
combinations of ``repro_torch.launch.dryrun`` at a cut depth, every
kernel's fake implementation against its plain version, and the topology
engine's rounds over a fake client world. Writes one JSON file.

  python tests/torch_dryrun_passes.py OUT.json

``--tally OUT.json`` instead traces the first train step of each of the
four-rank world's ``TALLY`` cases (``tests/torch_mesh_cases.py``) on rank 0
of a fake world of four, on fake CPU tensors as the gloo ranks run them
(the plain versions' collectives: on the card the kernels' group mode
issues others), and writes each one's collective tally, which
``tests/test_torch_dist_step.py`` holds against the gloo ranks'.

It must run under ``dryrun.tracer_env()``'s environment.
"""

import json
import resource
import sys

import torch

from repro_torch.launch import dryrun

LAYERS = 1  # the cut depth of the passes (the widths are the published ones)

# name -> (arch, shape, multi_pod, grad_sync)
PASSES = {
    "llama_train": ("llama3.2-1b", "train_4k", False, "paper"),
    "llama_prefill": ("llama3.2-1b", "prefill_32k", False, "paper"),
    "llama_decode": ("llama3.2-1b", "decode_32k", False, "paper"),
    "qwen2vl_train_fsdp": ("qwen2-vl-72b", "train_4k", False, "paper"),
    "musicgen_long_skipped": ("musicgen-large", "long_500k", False, "paper"),
    "mamba_long": ("mamba2-780m", "long_500k", False, "paper"),
    # the expert-parallel MoE runs under dense sync (the gmf modes run dense
    # experts), over the pod axis's 512 ranks
    "granite_train_ep": ("granite-moe-1b-a400m", "train_4k", True, "dense"),
}


def kernel_shapes() -> dict:
    """Each kernel wrapper's outputs (shape, dtype) on fake CUDA tensors and
    its plain version's on CPU tensors of the same shapes, in float32 and
    bfloat16."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ops
    from repro_torch.utils.flat import FlatLayout

    def calls(dev, dtype):
        tree = {"a": torch.zeros(3, 5, device=dev), "b": torch.zeros(7, device=dev)}
        lay = FlatLayout.of(tree)
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2, lay.total, generator=gen).to(dev, dtype)
        mask = (torch.rand(2, lay.total, generator=gen) > 0.5).float().to(dev)
        w, tau = torch.ones(2, device=dev), torch.full((2,), 0.3, device=dev)
        sel = ops.gmf_select(x, x, lay, 0.1, w=w, tau=tau, eps=1e-8)
        q = torch.randn(1, 64, 4, 64, generator=gen).to(dev, dtype)
        k = torch.randn(1, 64, 2, 64, generator=gen).to(dev, dtype)
        return {
            "momentum_correction": ops.momentum_correction(x, x, x, 0.9),
            "apply_mask": ops.apply_mask_update(x, x, mask),
            "gmf_select": sel,
            "gmf_compress": ops.gmf_compress(x, x, x, layout=lay, inv_norm_v=sel[0],
                                             inv_norm_m=sel[1], tau=tau, threshold=sel[2]),
            "topk_abs_select": ops.topk_abs_select(x, lay, 0.1),
            "flash_attention": k4.flash_attention(q, k, k),
        }

    def described(outs):
        return {name: [[list(t.shape), str(t.dtype)] for t in
                       (out if isinstance(out, (tuple, list)) else (out,))]
                for name, out in outs.items()}

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        plain = described(calls("cpu", dtype))
        with dryrun.fresh_caches(), FakeTensorMode():
            fake = described(calls("cuda", dtype))
        res[str(dtype)] = {"plain": plain, "fake": fake}
    return res


def tally(out_path: str) -> None:
    import dataclasses
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_cases as cases

    from repro_torch import configs
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.core import CompressionConfig
    from repro_torch.launch.mesh import make_mesh

    res = {}
    with dryrun.fake_world(cases.WORLD):
        for name in cases.TALLY:
            arch, over, shape, sync = cases.TRAIN[name]
            cfg = dataclasses.replace(configs.get_smoke(arch), **over)
            mesh = make_mesh(shape, cases.axes_of(shape), "cpu")
            tcfg = TrainConfig(learning_rate=cases.LR, total_steps=10, grad_sync=sync,
                               lr_schedule="cosine", warmup_steps=1)
            ccfg = CompressionConfig(**cases.scheme_of(name))
            batch = dryrun.input_specs(cfg, InputShape("tally", cases.SEQ, cases.BATCH, "train"),
                                       mode="train")
            got = dryrun.trace_train(cfg, tcfg, ccfg, mesh, batch, device="cpu")
            res[name] = {"counts": got["collective_counts"],
                         "bytes": {k: int(v) for k, v in got["collectives"].items()
                                   if k not in ("num_collectives", "total_bytes")}}
    with open(out_path, "w") as f:
        json.dump(res, f)


def main(out_path: str) -> None:
    res = {"records": {}}
    for multi in (False, True):
        names = [n for n, (_, _, m, _) in PASSES.items() if m == multi]
        with dryrun.fake_world(512 if multi else 256):
            for name in names:
                arch, shape, _, sync = PASSES[name]
                res["records"][name] = dryrun.lower_one(arch, shape, multi_pod=multi,
                                                        grad_sync=sync, layers=LAYERS)
    res["kernels"] = kernel_shapes()
    res["topology"] = {t: dryrun.lower_topology("llama3.2-1b", t, clients=8, device="cpu")
                       for t in ("ring", "hierarchical")}
    res["max_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    torch.set_num_threads(1)  # a test process beside the suite's workers (torch_threads.py)
    if sys.argv[1] == "--tally":
        tally(sys.argv[2])
    else:
        main(sys.argv[1])
