"""The dry run (``repro_torch.launch.dryrun``) against the reference's
``launch/dryrun.py``, and the fake implementations of the kernels.

- Argument bytes: for all 80 combinations of the reference's sweep (10
  archs × 4 shapes × 2 production meshes), the bytes of a step's inputs on
  rank 0 reckoned from shapes and specs alone, the port's
  (``dryrun.argument_bytes``: its inputs made on the meta device over an
  ``AbstractMesh``) against the reference's (``jax.eval_shape`` of params,
  train state, batch and cache, each leaf's shard bytes by
  ``repro.dist.sharding``'s specs at the production meshes). The train
  step's counter is an int32 scalar in the reference and a host int in the
  port: it is left out of the reference's count.
- Fake-tensor passes of a few combinations, at a cut depth
  (``tests/torch_dryrun_passes.py``, one subprocess for all: the fake world
  is global to a process), each record checked: the reference's keys
  (``trace_s`` for ``lower_s`` / ``compile_s``), the argument bytes equal
  to the spec reckoning of the same depth, the peak at least the
  arguments, the collective kinds the step issues, K4's fake launches in a
  prefill one per attention layer, the process's peak RSS under 8 GiB (no
  allocation at full scale); every kernel's fake outputs against its plain
  version's; a ring and a hierarchical round over a fake client world.
"""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import TrainConfig as JTrain  # noqa: E402
from repro.core import CompressionConfig as JComp  # noqa: E402
from repro.dist import sharding as jshr  # noqa: E402
from repro.dist import step as jstep  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

HERE = Path(__file__).resolve().parent
PASSES_TIMEOUT = 240
RSS_LIMIT = 8 * 2**30
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
COMBOS = [(a, s, m) for a in tconfigs.ARCH_IDS for s in J_SHAPES for m in (False, True)]

_PROC: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _spawn(tmp_path_factory):
    """Start the fake passes' process at once: the spec tests run while it
    works."""
    out = tmp_path_factory.mktemp("dryrun") / "passes.json"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"), **dryrun.tracer_env())
    _PROC["out"] = out
    _PROC["proc"] = subprocess.Popen([sys.executable, str(HERE / "torch_dryrun_passes.py"),
                                      str(out)], env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
    yield
    if _PROC["proc"].poll() is None:
        _PROC["proc"].kill()
        _PROC["proc"].wait()


@pytest.fixture(scope="module")
def passes():
    proc = _PROC["proc"]
    try:
        log = proc.communicate(timeout=PASSES_TIMEOUT)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log[-6000:]
    return json.loads(Path(_PROC["out"]).read_text())


# ---------------------------------------------------------------------------
# Argument bytes against the reference, from shapes and specs alone
# ---------------------------------------------------------------------------


def _shard_bytes(tree, specs, mesh) -> int:
    """Each leaf's bytes on one device: its dims divided by the product of
    the sizes of the axes its spec names."""
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves, strict=True):
        n = math.prod(x.shape)
        for entry in tuple(spec):
            for a in (entry if isinstance(entry, tuple) else (entry,)) if entry else ():
                n //= mesh.shape[a]
        total += n * np.dtype(x.dtype).itemsize
    return total


@functools.cache
def _ref_params(arch, long):
    cfg = jconfigs.get_long_variant(arch) if long else jconfigs.get_config(arch)
    return cfg, jax.eval_shape(lambda: jtr.init_params(cfg, jax.random.PRNGKey(0)))


def _ref_batch(cfg, shape, mode):
    """The reference dry run's ``input_specs`` (kept here: importing
    ``repro.launch.dryrun`` sets XLA_FLAGS for 512 devices)."""
    B, T, i32 = shape.global_batch, shape.seq_len, jnp.int32
    sds = jax.ShapeDtypeStruct
    if mode == "decode":
        if cfg.family == "audio":
            return {"tokens": sds((B, cfg.num_codebooks), i32)}
        return {"tokens": sds((B,), i32)}
    if cfg.family == "audio":
        b = {"tokens": sds((B, cfg.num_codebooks, T), i32)}
        if mode == "train":
            b["labels"] = sds((B, cfg.num_codebooks, T), i32)
        return b
    if cfg.family == "vlm":
        p = cfg.num_patches
        b = {"tokens": sds((B, T - p), i32),
             "patch_embeds": sds((B, p, cfg.d_model), jnp.dtype(cfg.dtype))}
        if mode == "train":
            b["labels"] = sds((B, T), i32)
        return b
    b = {"tokens": sds((B, T), i32)}
    if mode == "train":
        b["labels"] = sds((B, T), i32)
    return b


def _ref_argument_bytes(arch, shape_name, multi) -> int | None:
    shape = J_SHAPES[shape_name]
    if shape_name == "long_500k" and jconfigs.get_long_variant(arch) is None:
        return None
    cfg, params = _ref_params(arch, shape_name == "long_500k")
    mesh = JMesh(*MESHES[multi])
    pspecs = jshr.param_specs(params, fsdp=jstep.needs_fsdp(cfg), mesh=mesh)
    if shape.mode == "train":
        sync = jconfigs.default_grad_sync(cfg, multi_pod=multi)
        tcfg = JTrain(learning_rate=1e-2, total_steps=1000, grad_sync=sync)
        ccfg = JComp(scheme="dgcwgmf", rate=0.1, tau=0.3, selector="sampled")
        state = jax.eval_shape(lambda p: jstep.init_train_state(cfg, tcfg, ccfg, p, mesh),
                               params)
        specs = jstep.train_state_specs(cfg, tcfg, ccfg, params, mesh)
        state, specs = state._replace(step={}), specs._replace(step={})  # a host int in the port
        batch = _ref_batch(cfg, shape, "train")
        return (_shard_bytes(state, specs, mesh)
                + _shard_bytes(batch, jshr.train_batch_specs(cfg, mesh), mesh))
    if shape.mode == "prefill":
        batch = _ref_batch(cfg, shape, "prefill")
        bspecs = {k: v for k, v in jshr.train_batch_specs(cfg, mesh).items() if k in batch}
        return _shard_bytes(params, pspecs, mesh) + _shard_bytes(batch, bspecs, mesh)
    cache = jax.eval_shape(lambda: jtr.init_cache(cfg, shape.global_batch, shape.seq_len))
    tok = _ref_batch(cfg, shape, "decode")
    return (_shard_bytes(params, pspecs, mesh)
            + _shard_bytes(cache, jshr.cache_specs_from(cache, mesh), mesh)
            + _shard_bytes(tok, jshr.decode_batch_specs(cfg, mesh, shape.global_batch), mesh)
            + 4)  # pos: an int32 scalar, replicated


@pytest.mark.parametrize("arch,shape,multi", COMBOS,
                         ids=[f"{a}-{s}-{'pod2x16x16' if m else 'pod16x16'}"
                              for a, s, m in COMBOS])
def test_argument_bytes_equal_the_reference(arch, shape, multi):
    want = _ref_argument_bytes(arch, shape, multi)
    got = dryrun.argument_bytes(arch, shape, multi_pod=multi)
    assert got == want, (arch, shape, multi, got, want)


# ---------------------------------------------------------------------------
# Fake-tensor passes
# ---------------------------------------------------------------------------

REF_KEYS = {"status", "arch", "shape", "mesh", "chips", "mode", "memory", "cost", "collectives",
            "roofline_terms_s", "model", "dominant_term"}
TRAIN_KEYS = {"grad_sync", "scheme", "downlink"}
MEMORY_KEYS = {"argument_bytes_per_chip", "output_bytes_per_chip", "temp_bytes_per_chip",
               "peak_bytes_per_chip"}
# the kinds each pass's step must issue
KINDS = {"llama_train": {"all-reduce"},            # gmf_data's payload sum, TP
         "qwen2vl_train_fsdp": {"all-gather"},     # FSDP's gathers
         "granite_train_ep": {"all-to-all"},       # EP's dispatch
         "llama_prefill": {"all-reduce"}, "llama_decode": {"all-reduce"}}
OK_PASSES = ("llama_train", "llama_prefill", "llama_decode", "qwen2vl_train_fsdp", "mamba_long",
             "granite_train_ep")


def _pass(name):
    from torch_dryrun_passes import LAYERS, PASSES

    arch, shape, multi, sync = PASSES[name]
    return arch, shape, multi, sync, LAYERS


@pytest.mark.parametrize("name", OK_PASSES)
def test_fake_pass_record(passes, name):
    arch, shape, multi, sync, layers = _pass(name)
    rec = passes["records"][name]
    assert rec["status"] == "ok", rec
    assert REF_KEYS <= set(rec) and "trace_s" in rec, sorted(rec)
    assert not {"lower_s", "compile_s"} & set(rec)
    if rec["mode"] == "train":
        assert TRAIN_KEYS <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS
    mem = rec["memory"]
    assert mem["argument_bytes_per_chip"] == dryrun.argument_bytes(
        arch, shape, multi_pod=multi, grad_sync=sync, layers=layers), name
    assert mem["peak_bytes_per_chip"] >= mem["argument_bytes_per_chip"] > 0
    assert mem["temp_bytes_per_chip"] == (mem["peak_bytes_per_chip"]
                                          - mem["argument_bytes_per_chip"])
    assert rec["chips"] == (512 if multi else 256)
    coll = rec["collectives"]
    assert coll["num_collectives"] == sum(rec["collective_counts"].values()) > 0
    assert coll["total_bytes"] == sum(v for k, v in coll.items()
                                      if k not in ("num_collectives", "total_bytes"))
    assert KINDS.get(name, set()) <= set(rec["collective_counts"]), rec["collective_counts"]
    assert rec["cost"]["flops_per_chip"] > 0 and rec["cost"]["hbm_bytes_per_chip"] > 0
    terms = rec["roofline_terms_s"]
    assert rec["dominant_term"] == max(terms, key=terms.get)


def test_prefill_launches_k4_once_per_attention_layer(passes):
    arch, _, _, _, layers = _pass("llama_prefill")
    rec = passes["records"]["llama_prefill"]
    assert rec["kernels"]["flash_attention"] == layers
    assert passes["records"]["llama_decode"]["kernels"]["flash_attention"] == 0
    # the K4 formula's operations are counted: 2·B·H·T·S·D at S = T, causal
    assert rec["cost"]["flops_per_chip"] > 0


def test_long_context_skipped_exactly_where_the_reference_skips(passes):
    assert passes["records"]["musicgen_long_skipped"] == {
        "status": "skipped",
        "reason": "full attention; sub-quadratic variant not defined (DESIGN.md §5)"}
    assert jconfigs.get_long_variant("musicgen-large") is None
    assert jconfigs.get_long_variant("mamba2-780m") is not None
    assert passes["records"]["mamba_long"]["status"] == "ok"


def test_fake_passes_allocate_nothing_at_full_scale(passes):
    assert passes["max_rss_bytes"] < RSS_LIMIT


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
@pytest.mark.parametrize("kernel", ["momentum_correction", "apply_mask", "gmf_select",
                                    "gmf_compress", "topk_abs_select", "flash_attention"])
def test_fake_kernel_outputs_are_the_plain_versions(passes, kernel, dtype):
    got = passes["kernels"][dtype]
    assert got["fake"][kernel] == got["plain"][kernel]


@pytest.mark.parametrize("topology", ["ring", "hierarchical"])
def test_topology_round_over_a_fake_client_world(passes, topology):
    rec = passes["topology"][topology]
    assert rec["status"] == "ok" and rec["topology"] == topology and rec["chips"] == 8
    assert rec["collectives"]["num_collectives"] > 0
