"""Multi-pod dry run: the port of the reference's ``launch/dryrun.py``.

For every (architecture × input shape × mesh) combination it answers
"does a step fit a rank, and what does it cost?" without allocating
anything at full scale. The reference lowers and compiles each step on 256
or 512 faked XLA devices and reads ``memory_analysis()``,
``cost_analysis()`` and the partitioned HLO's collectives. The port has no
compiler to ask, so it runs rank 0's share of the step as a *fake-tensor
pass*: under ``torch._subclasses.FakeTensorMode`` every tensor is a fake
CUDA tensor (shapes, dtypes, strides, no storage), the world is a fake
process group of exactly 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives are issued,
nothing moves), and the step is the one the card runs, kernels included:
K1–K4 take their fake implementations (``kernels/gmf_compress.py``,
``kernels/flash_attention.py``), which allocate the launch's outputs and
count the launch. Rank 0's coordinate is 0 on every axis, so it owns every
shared piece and does the most work.

The record has the reference's keys, the numbers reckoned so:

- ``memory``: ``argument_bytes_per_chip`` the bytes of the step's inputs on
  the rank, ``output_bytes_per_chip`` those of its outputs,
  ``peak_bytes_per_chip`` the high-water mark of live storage bytes during
  the step (storages tracked by weak reference from their creation to
  their release, as the caching allocator sees them) and
  ``temp_bytes_per_chip`` the peak less the arguments;
- ``cost``: ``flops_per_chip`` from ``torch.utils.flop_counter`` (matmuls,
  convolutions, K4 by its registered formula), ``hbm_bytes_per_chip`` the
  sum of every op's input and output bytes, eager and unfused (an upper
  bound of what fusion would move);
- ``collectives``: ``obs.collectives.CollectiveTally``, the reference's
  kinds and byte convention (each collective's result buffer on the rank);
- ``roofline_terms_s`` and ``dominant_term`` over the NVIDIA H100 SXM5's
  published figures (below);
- ``trace_s`` (the pass's host time) in place of the reference's
  ``lower_s`` and ``compile_s``, which have no counterpart.

The records also carry ``collective_counts`` (per kind) and ``kernels``
(the fake launches per kernel).

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --topology ring --device cpu

It needs no card. A build of PyTorch with CUDA traces fake CUDA tensors as
it is; a build without CUDA cannot index one or run autograd over one, so
there ``main`` re-runs itself with a small C++ shim preloaded
(``csrc/fake_cuda.cpp``: c10's ``FakeGuardImpl`` as the CUDA device guard,
CUDA hooks that report an accelerator), built at first use with the host's
C++ compiler into ``build/dryrun/``. ``tracer_env()`` gives the environment
for such a process.

``lower_one(..., layers=N)`` cuts the depth (the full model's FSDP choice
and default grad-sync mode are kept), as the tests do; the CLI runs the
published depth.

Artifacts: ``experiments/dryrun_torch/<arch>__<shape>__<mesh>[__<sync>].json``
(topology runs: ``<arch>__topo_<topology>__clients<N>.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, TrainConfig
from repro_torch.core import CompressionConfig
from repro_torch.dist import sharding as shr
from repro_torch.dist import step as dstep
from repro_torch.launch.mesh import PRODUCTION_SHAPES, AbstractMesh, axis_size, \
    make_production_mesh
from repro_torch.models import transformer
from repro_torch.obs.collectives import CollectiveTally
from repro_torch.utils import tree_leaves, tree_map

# NVIDIA H100 SXM5 (80 GB HBM3), the vendor's published figures: the
# roofline denominators of one rank.
PEAK_FLOPS = 989.4e12   # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12        # bytes/s
# One 400 Gb/s NDR InfiniBand port per GPU: every axis of 16 ranks crosses
# nodes of 8 GPUs, so a collective over it runs at the network's rate.
ICI_BW = 50e9           # bytes/s per rank

SHIM_SOURCE = Path(__file__).resolve().parent / "csrc" / "fake_cuda.cpp"
SHIM_ROOT = Path(__file__).resolve().parents[3] / "build" / "dryrun"
_SHIM_MARK = "REPRO_DRYRUN_SHIM"


# ---------------------------------------------------------------------------
# Tracing fake CUDA tensors, and the fake world
# ---------------------------------------------------------------------------


def can_trace() -> bool:
    """Whether this process can trace fake CUDA tensors: PyTorch was built
    with CUDA, or the shim is loaded (it reports a CUDA accelerator)."""
    return torch.backends.cuda.is_built() or torch._C._get_accelerator().type == "cuda"


def build_shim() -> Path:
    """``csrc/fake_cuda.cpp`` compiled against this PyTorch (its headers,
    libc10 and libtorch_cpu), once per source and PyTorch."""
    tdir = Path(torch.__file__).resolve().parent
    key = hashlib.sha256(SHIM_SOURCE.read_bytes() + str(tdir).encode()
                         + torch.__version__.encode()).hexdigest()[:16]
    lib = SHIM_ROOT / key / "libfake_cuda.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.so")
    cmd = [os.environ.get("CXX", "c++"), "-O1", "-shared", "-fPIC", "-std=c++20",
           "-w", f"-I{tdir / 'include'}", str(SHIM_SOURCE), f"-L{tdir / 'lib'}",
           f"-Wl,-rpath,{tdir / 'lib'}", "-lc10", "-ltorch_cpu", "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"building the fake CUDA shim failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def tracer_env() -> dict:
    """Environment variables under which a new Python process of this
    PyTorch traces fake CUDA tensors: none where PyTorch has CUDA, else the
    shim preloaded."""
    if torch.backends.cuda.is_built():
        return {}
    pre = os.environ.get("LD_PRELOAD", "")
    lib = str(build_shim())
    return {"LD_PRELOAD": f"{lib}:{pre}" if pre else lib, _SHIM_MARK: "1"}


def _fake_pg():
    """The fake process group's store (``torch.testing``'s ``fake_pg``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore


_WORLD: dict = {}


@contextlib.contextmanager
def fake_world(world: int):
    """A fake world of ``world`` ranks (256 or 512 for the production
    meshes) in which this process is rank 0; torn down on exit. Refuses to
    run where a process group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the dry run builds its "
                           "own fake world and runs in a process of its own")
    dist.init_process_group("fake", store=_fake_pg()(), rank=0, world_size=world)
    _WORLD.clear()
    try:
        yield
    finally:
        _WORLD.clear()
        dstep._GROUPS.clear()
        dist.destroy_process_group()


def _mesh(multi_pod: bool):
    """The production mesh of the current fake world, made once per world."""
    if multi_pod not in _WORLD:
        _WORLD[multi_pod] = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    return _WORLD[multi_pod]


@contextlib.contextmanager
def fresh_caches():
    """The caches of device tensors (the flat layouts, ``utils.flat``; the
    count sketch's tables, ``core.sketch``) emptied for a pass and put back
    after it: a pass's entries hold its fake tensors, and an entry a real
    run made holds real ones, which a fake pass must not take."""
    from repro_torch.core import sketch
    from repro_torch.utils import flat

    caches = (flat._LAYOUTS, sketch._TABLES)
    saved = [dict(c) for c in caches]
    for c in caches:
        c.clear()
    try:
        yield
    finally:
        for c, old in zip(caches, saved, strict=True):
            c.clear()
            c.update(old)


# ---------------------------------------------------------------------------
# Meters
# ---------------------------------------------------------------------------

_FREE_OPS = {"aten::detach", "aten::alias", "aten::empty", "aten::empty_like",
             "aten::empty_strided", "aten::new_empty", "aten::new_empty_strided",
             "aten::lift_fresh", "prim::device", "aten::_local_scalar_dense"}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class _Meter(TorchDispatchMode):
    """Live storage bytes and their peak (each storage counted from the op
    that made it until it is released), and every op's input and output
    bytes (views and allocations move none)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.hbm = 0
        self._sizes: dict = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if not func.is_view and func._schema.name not in _FREE_OPS:
            ins = _tensors(list(args) + list(kwargs.values()))
            ids = {id(t) for t in ins}
            self.hbm += sum(t.numel() * t.element_size()
                            for t in ins + [t for t in outs if id(t) not in ids])
        return out


def _kernel_counts() -> dict:
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import gmf_compress as gk

    return {**gk.FAKE_LAUNCHES, "flash_attention": k4.FAKE_LAUNCHES["flash_attention"]}


def _reset_kernels() -> None:
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import gmf_compress as gk

    gk.FAKE_LAUNCHES.clear()
    for k in k4.FAKE_LAUNCHES:
        k4.FAKE_LAUNCHES[k] = 0


def measure(fn, inputs) -> dict:
    """Run ``fn()`` once under the meters, ``inputs`` the step's arguments
    (already made): the record's ``memory``, ``cost``, ``collectives`` and
    the fake kernel launches."""
    from torch.utils.flop_counter import FlopCounterMode

    _reset_kernels()
    meter, tally = _Meter(), CollectiveTally()
    args = storage_bytes(inputs)
    for t in _tensors(inputs):
        meter.track(t)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    # (the backward on the calling thread, where the modes are: autograd's
    # device threads would not see them)
    with torch.autograd.set_multithreading_enabled(False), flops, meter, tally:
        out = fn()
    trace_s = time.perf_counter() - t0
    in_keys = {t.untyped_storage()._cdata for t in _tensors(inputs)}
    outs = {}
    for t in _tensors(out):
        st = t.untyped_storage()
        if st._cdata not in in_keys:
            outs[st._cdata] = st.nbytes()
    return {
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes_per_chip": args,
            "output_bytes_per_chip": sum(outs.values()),
            "temp_bytes_per_chip": meter.peak - args,
            "peak_bytes_per_chip": meter.peak,
        },
        "cost": {"flops_per_chip": float(flops.get_total_flops()),
                 "hbm_bytes_per_chip": float(meter.hbm)},
        "collectives": tally.summary(),
        "collective_counts": dict(tally.counts),
        "kernels": _kernel_counts(),
    }


# ---------------------------------------------------------------------------
# Inputs, local pieces, the steps
# ---------------------------------------------------------------------------


def input_specs(cfg, shape, *, mode: str) -> dict:
    """Meta-device stand-ins (shapes, dtypes, no storage) for every model
    input of the global batch, the counterpart of the reference's
    ``ShapeDtypeStruct``s."""
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def t(*s, dtype=i32):
        return torch.empty(s, dtype=dtype, device="meta")

    if mode in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {"tokens": t(B, cfg.num_codebooks, T)}
            if mode == "train":
                batch["labels"] = t(B, cfg.num_codebooks, T)
            return batch
        if cfg.family == "vlm":
            p = cfg.num_patches
            batch = {"tokens": t(B, T - p),
                     "patch_embeds": t(B, p, cfg.d_model, dtype=getattr(torch, cfg.dtype))}
            if mode == "train":
                batch["labels"] = t(B, T)
            return batch
        batch = {"tokens": t(B, T)}
        if mode == "train":
            batch["labels"] = t(B, T)
        return batch
    if mode == "decode":
        if cfg.family == "audio":
            return {"tokens": t(B, cfg.num_codebooks)}
        return {"tokens": t(B)}
    raise ValueError(mode)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """A leaf's piece on a rank: each dim divided by the product of the
    sizes of the axes its spec entry names."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
            out[d] //= axis_size(mesh, a)
    return tuple(out)


def _local(tree, specs, mesh, device):
    """Empty tensors of each leaf's piece (``specs`` mirroring ``tree``)."""
    return tree_map(lambda x, s: torch.empty(local_shape(x.shape, s, mesh), dtype=x.dtype,
                                             device=device), tree, specs)


def _configs(arch_id, shape_name, layers):
    """(cfg, full cfg, skip reason) of a combination; ``layers`` cuts the
    depth."""
    if shape_name == "long_500k":
        full = configs.get_long_variant(arch_id)
        if full is None:
            return None, None, ("full attention; sub-quadratic variant not defined "
                                "(DESIGN.md §5)")
    else:
        full = configs.get_config(arch_id)
    cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
    return cfg, full, None


@contextlib.contextmanager
def _fsdp_as(full):
    """FSDP as the full-depth model chooses it, whatever the depth."""
    saved = dstep._FSDP_PARAM_THRESHOLD
    dstep._FSDP_PARAM_THRESHOLD = 0.0 if full.param_count() > saved else math.inf
    try:
        yield
    finally:
        dstep._FSDP_PARAM_THRESHOLD = saved


def _train_configs(full, multi_pod, grad_sync, wire_dtype, downlink):
    sync = (configs.default_grad_sync(full, multi_pod=multi_pod) if grad_sync == "paper"
            else grad_sync)
    tcfg = TrainConfig(learning_rate=1e-2, total_steps=1000, grad_sync=sync)
    ccfg = CompressionConfig(
        scheme="dgcwgmf", rate=0.1, tau=0.3,
        selector="sampled",  # the reference's production selector
        wire_dtype=wire_dtype,
        downlink_stage=None if downlink == "none" else downlink)
    return sync, tcfg, ccfg


def _inputs(cfg, shape, mode, mesh, *, tcfg=None, ccfg=None, device="cuda", cache=None):
    """The step's inputs on a rank (the current tensor mode's: meta, fake or
    real empty tensors): train (state, batch), prefill (params, batch) or
    decode (params, cache, tokens, pos). The decode cache is laid out by the
    reference's ``cache_specs_from`` unless ``cache`` (a tree of tensors
    whose shapes and dtypes to take) is given."""
    abstract = transformer.abstract_params(cfg)
    pspecs = shr.param_specs(abstract, fsdp=dstep.needs_fsdp(cfg), mesh=mesh)
    params = _local(abstract, pspecs, mesh, device)
    if mode == "train":
        bspecs = dstep.step_batch_specs(cfg, tcfg, mesh)
        batch = _local(input_specs(cfg, shape, mode="train"), bspecs, mesh, device)
        state = dstep.init_train_state(cfg, tcfg, ccfg, params, mesh)
        return state, batch
    if mode == "prefill":
        batch_meta = input_specs(cfg, shape, mode="prefill")
        bspecs = {k: v for k, v in shr.train_batch_specs(cfg, mesh).items() if k in batch_meta}
        return params, _local(batch_meta, bspecs, mesh, device)
    if cache is None:
        cache_meta = transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                            device="meta")
        cache = _local(cache_meta, shr.cache_specs_from(cache_meta, mesh), mesh, device)
    else:
        cache = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device), cache)
    tok_meta = input_specs(cfg, shape, mode="decode")["tokens"]
    tspec = shr.decode_batch_specs(cfg, mesh, shape.global_batch)["tokens"]
    tokens = torch.empty(local_shape(tok_meta.shape, tspec, mesh), dtype=torch.int32,
                         device=device)
    pos = torch.full((), shape.seq_len - 1, dtype=torch.int32, device=device)
    return params, cache, tokens, pos


def _prefilled_cache(cfg, shape, mesh, params):
    """The decode cache as the port's prefill leaves it on the rank (a
    one-token prompt of the decode batch's rows prefilled into
    ``shape.seq_len`` slots, traced): the KV entries as ``cache_specs_from``
    lays them, the recurrent families' states cut over the model axis as
    their tensor-parallel decode reads them (the reference keeps those
    whole over ``model``)."""
    tspec = shr.decode_batch_specs(cfg, mesh, shape.global_batch)["tokens"]
    rows = local_shape((shape.global_batch,), tspec, mesh)[0]
    dev = tree_leaves(params)[0].device
    tok = (rows, cfg.num_codebooks, 1) if cfg.family == "audio" else (rows, 1)
    batch = {"tokens": torch.empty(tok, dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":  # a text prompt: no patches
        batch["patch_embeds"] = torch.empty((rows, 0, cfg.d_model),
                                            dtype=getattr(torch, cfg.dtype), device=dev)
    prefill = dstep.make_prefill_step(cfg, mesh, cache_len=shape.seq_len)
    return prefill(params, batch)[1]


def argument_bytes(arch_id: str, shape_name: str, *, multi_pod: bool, grad_sync: str = "paper",
                   wire_dtype: str = "float32", downlink: str = "none",
                   layers: int | None = None) -> int | None:
    """The bytes of a combination's step inputs on rank 0, reckoned from
    shapes and specs alone: the inputs made on the meta device over an
    ``AbstractMesh`` (no world, no trace). None where the reference skips
    the combination. The train step's counter is a host int in the port
    (an int32 scalar in the reference) and counts no bytes."""
    cfg, full, skip = _configs(arch_id, shape_name, layers)
    if skip:
        return None
    shape = INPUT_SHAPES[shape_name]
    mesh = AbstractMesh(*PRODUCTION_SHAPES[multi_pod])
    with _fsdp_as(full):
        if shape.mode == "train":
            _, tcfg, ccfg = _train_configs(full, multi_pod, grad_sync, wire_dtype, downlink)
            inputs = _inputs(cfg, shape, "train", mesh, tcfg=tcfg, ccfg=ccfg, device="meta")
        else:
            inputs = _inputs(cfg, shape, shape.mode, mesh, device="meta")
    return sum(t.numel() * t.element_size() for t in _tensors(inputs))


def trace_train(cfg, tcfg, ccfg, mesh, batch_meta, *, device="cuda") -> dict:
    """One train step of ``cfg`` as a fake-tensor pass on this rank over
    ``mesh`` (None: mesh-less), ``batch_meta`` the global batch's meta
    stand-ins (``input_specs``): ``measure``'s dict, without the outputs.
    The step (and the mesh's groups it makes) is built outside the fake
    mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    step = dstep.make_train_step(cfg, tcfg, ccfg, mesh)
    with fresh_caches(), FakeTensorMode():
        if mesh is None:
            abstract = transformer.abstract_params(cfg)
            params = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device),
                              abstract)
            batch = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device),
                             batch_meta)
        else:
            abstract = transformer.abstract_params(cfg)
            pspecs = shr.param_specs(abstract, fsdp=dstep.needs_fsdp(cfg), mesh=mesh)
            params = _local(abstract, pspecs, mesh, device)
            batch = _local(batch_meta, dstep.step_batch_specs(cfg, tcfg, mesh), mesh, device)
        state = dstep.init_train_state(cfg, tcfg, ccfg, params, mesh)
        del params
        inputs = (state, batch)
        got = measure(lambda: step(*inputs), inputs)
        del inputs, state
    return got


def lower_one(arch_id: str, shape_name: str, *, multi_pod: bool, grad_sync: str,
              wire_dtype: str = "float32", downlink: str = "none",
              layers: int | None = None) -> dict:
    """One combination's fake-tensor pass on rank 0 of the current fake
    world (``fake_world``; made here for the call if there is none) -> its
    record. ``long_500k`` takes the arch's long-context variant and is
    skipped, as in the reference, where there is none."""
    if not dist.is_initialized():
        with fake_world(math.prod(PRODUCTION_SHAPES[multi_pod][0])):
            return lower_one(arch_id, shape_name, multi_pod=multi_pod, grad_sync=grad_sync,
                             wire_dtype=wire_dtype, downlink=downlink, layers=layers)
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, full, skip = _configs(arch_id, shape_name, layers)
    if skip:
        return {"status": "skipped", "reason": skip}
    shape = INPUT_SHAPES[shape_name]
    mesh = _mesh(multi_pod)
    extra = {}
    with _fsdp_as(full):
        if shape.mode == "train":
            sync, tcfg, ccfg = _train_configs(full, multi_pod, grad_sync, wire_dtype, downlink)
            got = trace_train(cfg, tcfg, ccfg, mesh, input_specs(cfg, shape, mode="train"))
            extra = {"grad_sync": sync, "scheme": "dgcwgmf", "downlink": downlink}
        else:
            # the step (and the mesh's groups it makes) outside the fake mode
            step = (dstep.make_prefill_step(cfg, mesh, cache_len=shape.seq_len)
                    if shape.mode == "prefill" else dstep.make_serve_step(cfg, mesh))
            with fresh_caches(), FakeTensorMode():
                if shape.mode == "prefill":
                    inputs = _inputs(cfg, shape, "prefill", mesh)
                else:
                    params = _inputs(cfg, shape, "prefill", mesh)[0]
                    inputs = _inputs(cfg, shape, "decode", mesh,
                                     cache=_prefilled_cache(cfg, shape, mesh, params))
                    del params
                got = measure(lambda: step(*inputs), inputs)
                del inputs
    coll = got["collectives"]
    flops, hbm = got["cost"]["flops_per_chip"], got["cost"]["hbm_bytes_per_chip"]
    record = {
        "status": "ok",
        "arch": arch_id,
        "shape": shape_name,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "chips": mesh.size(),
        "mode": shape.mode,
        **extra,
        "layers": cfg.num_layers,
        "trace_s": got["trace_s"],
        "memory": got["memory"],
        "cost": got["cost"],
        "collectives": coll,
        "collective_counts": got["collective_counts"],
        "kernels": got["kernels"],
        "roofline_terms_s": {
            "compute": flops / PEAK_FLOPS,
            "memory": hbm / HBM_BW,
            "collective": coll["total_bytes"] / ICI_BW,
        },
        "model": {
            "params": full.param_count(),
            "active_params": full.active_param_count(),
        },
    }
    terms = record["roofline_terms_s"]
    record["dominant_term"] = max(terms, key=terms.get)
    return record


def lower_topology(arch_id: str, topology: str, *, clients: int = 8, ring_hops: int = 1,
                   groups: int = 2, batch: int = 2, seq_len: int = 128,
                   device: str = "cuda") -> dict:
    """One ring or hierarchical round of the port's topology engine
    (``fl.engine.TopologyEngine``, shard backend) at smoke scale over a
    fake world of ``clients`` ranks, this process rank 0. Unlike
    ``lower_one`` it allocates real smoke-scale state on ``device`` (the
    engine reads the round's counts back to the host); over the fake world
    the collectives move nothing, so the numbers it computes are not the
    round's, but the collectives it issues are: the record's point."""
    from repro_torch.fl import FLConfig, FLSimulator, LMTask

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised: the dry run builds its "
                           "own fake world and runs in a process of its own")
    cfg = configs.get_smoke(arch_id)
    fl = FLConfig(num_clients=clients, rounds=1, batch_size=batch, backend="shard",
                  shards=clients, topology=topology,
                  ring_hops=ring_hops if topology == "ring" else 0,
                  groups=groups if topology == "hierarchical" else 1)
    ccfg = CompressionConfig(scheme="dgcwgmf", rate=0.1, tau=0.3, selector="sampled")
    dist.init_process_group("fake", store=_fake_pg()(), rank=0, world_size=clients)
    try:
        task = LMTask(cfg, num_clients=clients, batch_size=batch, seq_len=seq_len,
                      device=device)
        sim = FLSimulator(fl, ccfg, task.init_fn, task.loss_fn, device=device)
        inputs = (sim.params, sim.cstates, sim.sstate, sim.gbar_prev)
        provider = task.batch_provider
        got = measure(lambda: sim.run(provider), inputs)
    finally:
        dist.destroy_process_group()
    return {
        "status": "ok",
        "arch": arch_id,
        "mesh": f"clients{clients}",
        "chips": clients,
        "mode": "fl_round",
        "topology": topology,
        "scheme": "dgcwgmf",
        "ring_hops": ring_hops if topology == "ring" else 0,
        "groups": groups if topology == "hierarchical" else 1,
        "trace_s": got["trace_s"],
        "memory": {k: v for k, v in got["memory"].items() if k != "peak_bytes_per_chip"},
        "cost": got["cost"],
        "collectives": got["collectives"],
        "collective_counts": got["collective_counts"],
        "model": {"params": cfg.param_count()},
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _tag(arch, shape, mesh_name, args) -> str:
    tag = f"{arch}__{shape}__{mesh_name}"
    train = INPUT_SHAPES[shape].mode == "train"
    if args.grad_sync != "paper" and train:
        tag += f"__{args.grad_sync}"
    if args.wire_dtype != "float32" and train:
        tag += "__wire16"
    if args.downlink != "none" and train:
        tag += f"__dl_{args.downlink}"
    return tag


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch × shape)")
    ap.add_argument("--grad-sync", default="paper",
                    choices=["paper", "dense", "gmf_data", "gmf_pod"],
                    help="'paper' = per-arch default (GMF where it fits)")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=["float32", "bfloat16", "float16"],
                    help="sync payload dtype (bfloat16 = quantisation-aware EF)")
    ap.add_argument("--downlink", default="none", choices=["none", "topk"],
                    help="downlink stage for train shapes")
    ap.add_argument("--topology", default="none", choices=["none", "ring", "hierarchical"],
                    help="run a TopologyEngine FL round over a fake client world instead of "
                         "the dist step sweep")
    ap.add_argument("--clients", type=int, default=8,
                    help="topology runs: cohort size = client world size")
    ap.add_argument("--ring-hops", type=int, default=1, help="topology ring: handoffs per segment")
    ap.add_argument("--groups", type=int, default=2,
                    help="topology hierarchical: edge aggregator count")
    ap.add_argument("--device", default="cuda",
                    help="topology runs: the device of the smoke-scale state")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    return ap


def _fail(record_base, e) -> dict:
    return {"status": "failed", **record_base, "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if not can_trace():
        if os.environ.get(_SHIM_MARK):
            raise RuntimeError("the fake CUDA shim is preloaded but PyTorch reports no CUDA "
                               "accelerator")
        env = dict(os.environ, **tracer_env())
        return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
                              env=env, check=False).returncode
    from torch.testing._internal.distributed import fake_pg  # noqa: F401  (must exist)

    print(f"torch {torch.__version__} (cuda {torch.version.cuda}); fake process group: "
          f"{fake_pg.__name__}", flush=True)
    archs = list(configs.ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    if args.topology != "none":
        for arch in archs:
            tag = f"{arch}__topo_{args.topology}__clients{args.clients}"
            print(f"=== {tag}", flush=True)
            try:
                record = lower_topology(arch, args.topology, clients=args.clients,
                                        ring_hops=args.ring_hops, groups=args.groups,
                                        device=args.device)
            except Exception as e:
                failures += 1
                record = _fail({"arch": arch, "topology": args.topology}, e)
                print(f"    FAILED: {record['error'][:300]}", flush=True)
            else:
                c = record["collectives"]
                print(f"    ok  trace={record['trace_s']}s "
                      f"collectives={c['num_collectives']} "
                      f"coll_bytes/chip={c['total_bytes'] / 1e6:.2f}MB", flush=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(record, f, indent=2)
        print(f"done; {failures} failures")
        return 1 if failures else 0
    for multi in meshes:
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        with fake_world(math.prod(PRODUCTION_SHAPES[multi][0])):
            for arch in archs:
                for shape in shapes:
                    tag = _tag(arch, shape, mesh_name, args)
                    print(f"=== {tag}", flush=True)
                    try:
                        record = lower_one(arch, shape, multi_pod=multi,
                                           grad_sync=args.grad_sync, wire_dtype=args.wire_dtype,
                                           downlink=args.downlink)
                    except Exception as e:  # a failure here is a bug in the system
                        failures += 1
                        record = _fail({"arch": arch, "shape": shape, "mesh": mesh_name}, e)
                        print(f"    FAILED: {record['error'][:300]}", flush=True)
                    else:
                        if record["status"] == "ok":
                            t = record["roofline_terms_s"]
                            peak = record["memory"]["peak_bytes_per_chip"]
                            print(f"    ok  trace={record['trace_s']}s "
                                  f"peak/chip={peak / 1e9:.2f}GB "
                                  f"compute={t['compute'] * 1e3:.2f}ms "
                                  f"mem={t['memory'] * 1e3:.2f}ms "
                                  f"coll={t['collective'] * 1e3:.2f}ms "
                                  f"dom={record['dominant_term']}", flush=True)
                        else:
                            print(f"    skipped: {record['reason']}", flush=True)
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(record, f, indent=2)
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
