"""The rest of the training slice against the JAX package: the optimisers
(SGD with clip, decay, momentum and nesterov; AdamW; ``lr_at`` under every
schedule), the checkpoint format (the ``.meta`` sidecar byte for byte what
``msgpack.packb`` writes; checkpoints restore across the packages both
ways), the trainer's refusals (FetchSGD's ``owns_lr`` branch and its
decay/clip refusal, a mesh, ``gmf_pod`` without a pod axis), remat (the
same values with and without it), the layout of a tree of mixed dtypes,
and ``launch/train.py --smoke --device cpu`` lowering its loss through
``--backend dist`` and ``--backend fl``.

Tolerances: float32 optimiser steps within 1e-6 of each leaf's largest
magnitude (jitted JAX contracts ``w - lr*u`` into one rounding, ROADMAP
R3); ``lr_at`` within 1e-6 relative (the cosine's libm); everything else
exact.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp
msgpack = pytest.importorskip("msgpack")

import torch_train_parity as tr
from repro import checkpoint as jckpt
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch import checkpoint as tckpt
from repro_torch.checkpoint import io as tio
from repro_torch.core import CompressionConfig
from repro_torch.dist import step as tstep
from repro_torch.models import transformer as ttr
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import sgd as tsgd
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params
from repro_torch.utils.flat import FlatLayout, GroupedLayout

ROOT = Path(__file__).resolve().parents[1]


def _trees(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 5), "b": {"c": (7,), "d": (2, 3, 2)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.normal(size=s).astype(dtype)

    return make(shapes)


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


@pytest.mark.parametrize("kw", [dict(), dict(grad_clip=0.5), dict(weight_decay=0.01),
                                dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
                                dict(momentum=0.9, weight_decay=0.1, grad_clip=1.0)])
def test_sgd_matches_jax(kw):
    (jp, tp), (jg, tg) = _both(_trees(0)), _both(_trees(1))
    jst = jsgd.init(jp, momentum=kw.get("momentum", 0.0))
    tst = tsgd.init(tp, momentum=kw.get("momentum", 0.0))
    step = jax.jit(lambda p, g, s: jsgd.apply_updates(p, g, s, lr=jnp.float32(0.05), **kw))
    for _ in range(3):
        jp, jst = step(jp, jg, jst)
        tp, tst = tsgd.apply_updates(tp, tg, tst, lr=0.05, **kw)
    assert max(tr.leaf_errors(tp, jp)) <= 1e-6
    if kw.get("momentum"):
        assert max(tr.leaf_errors(tst.momentum, jst.momentum)) <= 1e-6


def test_adamw_matches_jax():
    (jp, tp), (jg, tg) = _both(_trees(2)), _both(_trees(3))
    jst, tst = jadamw.init(jp), tadamw.init(tp)
    step = jax.jit(lambda p, g, s: jadamw.apply_updates(p, g, s, lr=jnp.float32(0.01),
                                                        weight_decay=0.1))
    for _ in range(3):
        jp, jst = step(jp, jg, jst)
        tp, tst = tadamw.apply_updates(tp, tg, tst, lr=0.01, weight_decay=0.1)
    assert max(tr.leaf_errors(tp, jp)) <= 1e-6
    assert max(tr.leaf_errors(tst.mu, jst.mu)) <= 1e-6 and tst.count == int(jst.count) == 3


@pytest.mark.parametrize("schedule", ["constant", "cosine", "step"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_at_matches_jax(schedule, warmup):
    jt, tt = (dataclasses.replace(c, lr_schedule=schedule, warmup_steps=warmup, total_steps=17)
              for c in tr.train_configs("dense"))
    for step in range(20):
        want = float(jsgd.lr_at(step, jt))
        got = tsgd.lr_at(step, tt)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30), (step, got, want)
    with pytest.raises(ValueError):
        tsgd.lr_at(0, dataclasses.replace(tt, lr_schedule="linear"))


@pytest.mark.parametrize("obj", [
    {"step": 0, "meta": {}, "keys": []},
    {"step": 12, "meta": {}, "keys": ["embed/table", "layers/0/attn/wq", "tail/1/mlp/up"]},
    {"step": 70000, "meta": {"arch": "llama3.2-1b", "lr": 0.003, "smoke": True, "note": None,
                             "tags": ["a", "b" * 40], "n": -3, "big": 2**40, "neg": -40000},
     "keys": ["x" * 300] + [str(i) for i in range(20)]},
])
def test_meta_sidecar_is_msgpack_byte_for_byte(obj):
    assert tio.packb(obj) == msgpack.packb(obj)
    assert tio.unpackb(msgpack.packb(obj)) == msgpack.unpackb(msgpack.packb(obj)) == obj


def test_meta_sidecar_refuses_what_it_does_not_hold():
    with pytest.raises(TypeError):
        tio.packb({"step": 1, "meta": {"x": b"bytes"}, "keys": []})
    with pytest.raises(ValueError):
        tio.unpackb(msgpack.packb({"x": b"bytes"}))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_checkpoints_restore_across_the_packages(arch, tmp_path):
    """A checkpoint written by either package restores under the other
    (float32 at ``smoke()``), and a JAX-written bfloat16 one restores into
    the port bit for bit (the reference stores bfloat16 as 2-byte void
    arrays, which its own ``restore`` cannot cast back: ROADMAP R13)."""
    for dtype in ("float32", "bfloat16"):
        jcfg, _ = tr.configs(arch, dtype)
        jp, np_params = tr.jax_params(jcfg, seed=4)
        tp = from_jax_params(np_params, layout="transformer")
        jckpt.save(str(tmp_path / f"j{dtype}"), jp, step=5)
        got = tckpt.restore(str(tmp_path / f"j{dtype}"), tp)
        assert max(tr.leaf_errors(got, jp)) == 0.0
        assert tckpt.load_meta(str(tmp_path / f"j{dtype}")) == jckpt.load_meta(
            str(tmp_path / f"j{dtype}"))
        tckpt.save(str(tmp_path / f"t{dtype}"), tp, step=5)
        assert (tmp_path / f"t{dtype}.meta").read_bytes() == (
            tmp_path / f"j{dtype}.meta").read_bytes()
        if dtype == "float32":
            back = jckpt.restore(str(tmp_path / f"t{dtype}"), jp)
            assert max(tr.leaf_errors(tp, back)) == 0.0


def test_fetchsgd_owns_lr_and_refuses_decay_and_clip():
    jst, tst, ((jm, tm),) = tr.one_step("llama3.2-1b", "gmf_data", scheme="fetchsgd")
    assert int(tm["upload_nnz"][0]) == int(np.asarray(jm["upload_nnz"])[0])
    assert int(tm["download_nnz"]) == int(jm["download_nnz"])
    assert max(tr.leaf_errors(tst.params, jst.params)) <= 1e-5
    _, tcfg = tr.configs("llama3.2-1b")
    for bad in (dict(weight_decay=0.1), dict(grad_clip=1.0)):
        _, tt = tr.train_configs("gmf_data", **bad)
        with pytest.raises(ValueError, match="folds the learning rate"):
            tstep.make_train_step(tcfg, tt, CompressionConfig(scheme="fetchsgd"))


def test_trainer_refuses_a_mesh_and_unknown_sync():
    """FSDP (a >40 B arch on a data axis over 1) runs (ROADMAP item 11 part
    C2a; the name is older than the port and kept): the >40 B archs cut
    their params over ``data`` on a data axis over 1 and only there, by the
    40e9 threshold (FSDP's steps against JAX: ``tests/test_torch_dist_step.py``);
    an unknown sync raises."""
    from repro_torch import configs as tconfigs
    from repro_torch.launch.mesh import AbstractMesh

    _, tcfg = tr.configs("llama3.2-1b")
    for arch in ("qwen2-vl-72b", "command-r-plus-104b", "kimi-k2-1t-a32b"):
        big = tconfigs.get_config(arch)
        assert tstep.fsdp_active(big, AbstractMesh((2, 2), ("data", "model")))
        assert not tstep.fsdp_active(big, AbstractMesh((1, 2), ("data", "model")))
        assert not tstep.fsdp_active(tconfigs.get_smoke(arch),
                                     AbstractMesh((2, 2), ("data", "model")))
    assert not tstep.fsdp_active(tconfigs.get_config("yi-34b"),
                                 AbstractMesh((2, 2), ("data", "model")))
    _, bad = tr.train_configs("allreduce")
    with pytest.raises(ValueError, match="grad_sync"):
        tstep.make_train_step(tcfg, bad, CompressionConfig())
    # gmf_pod at one shard is gmf_data's step
    _, pod = tr.train_configs("gmf_pod")
    assert tstep._num_shards("gmf_pod", None) == 1
    tstep.make_train_step(tcfg, pod, CompressionConfig())


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_changes_memory_not_values(policy):
    _, tcfg = tr.configs("qwen2.5-3b")
    p = ttr.init_params(tcfg, torch.Generator().manual_seed(0))
    tok = torch.randint(0, tcfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": tok}
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        (loss, _), g = tstep._value_and_grad(tstep.make_loss_fn(cfg), p, batch)
        out.append((loss, tree_leaves(g)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1], strict=True))


def test_chunked_attention_inner_remat_keeps_values():
    from repro_torch.models import attention

    rng = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, 4, 8, generator=rng, requires_grad=True) for _ in range(3))
    outs = []
    for inner in (False, True):
        o = attention.chunked_causal_attention(q, k, v, chunk=8, window=12, inner_remat=inner)
        outs.append((o, torch.autograd.grad(o.square().sum(), (q, k, v))))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1], strict=True))


def test_grouped_layout_of_a_mixed_tree():
    """A tree of mixed dtypes: one float32 and one bfloat16 group, each in
    tree_leaves order; flatten/unflatten round trip; zeros in each group's
    dtype; an all-float32 tree keeps its one-stack layout."""
    tree = {"a": torch.ones(2, 3, dtype=torch.bfloat16), "b": torch.arange(4.0),
            "c": torch.full((5,), 2.0, dtype=torch.bfloat16)}
    layout = FlatLayout.of(tree)
    assert isinstance(layout, GroupedLayout)
    assert layout.dtypes == (torch.bfloat16, torch.float32) and layout.index == ((0, 2), (1,))
    assert [g.total for g in layout.groups] == [11, 4] and layout.total == 15
    flat = layout.flatten(tree)
    assert [f.dtype for f in flat] == [torch.bfloat16, torch.float32]
    back = layout.unflatten(flat)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    assert [z.dtype for z in layout.zeros()] == [torch.bfloat16, torch.float32]
    f32 = FlatLayout.of({"b": torch.arange(4.0), "d": torch.zeros(3)})
    assert f32.groups is None and f32.zeros().dtype == torch.float32 and f32.total == 7


@pytest.mark.parametrize("backend", ["dist", "fl"])
def test_launch_train_smoke_lowers_the_loss_on_the_cpu(backend, tmp_path):
    """The reference's own smoke recipes (its verify notes): 12 steps of
    batch 8 at sequence 64 through the trainer, 6 rounds of 4 clients
    (batch 2, sequence 32, lr 0.25) through the FL engines."""
    steps = 12 if backend == "dist" else 6
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", str(steps),
            "--log-every", "4", "--checkpoint", str(tmp_path / "ck"),
            "--metrics-out", str(tmp_path / "m.json")]
    if backend == "dist":
        args += ["--batch", "8", "--seq-len", "64"]
    else:
        args += ["--backend", "fl", "--clients", "4", "--batch", "2", "--seq-len", "32",
                 "--lr", "0.25"]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                               "OMP_NUM_THREADS": "2"},
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "(improved)" in proc.stdout
    assert tckpt.load_meta(str(tmp_path / "ck"))["step"] == steps


def test_launch_train_refuses_a_mesh_and_a_missing_card():
    """``--mesh-shape`` without a torchrun world raises (a model axis over 1
    runs in one: ``tests/test_torch_dist_step.py``); without a card the
    default device raises."""
    from repro_torch.launch import train

    ns = train.parser().parse_args(["--arch", "llama3.2-1b", "--mesh-shape", "2,2"])
    with pytest.raises(SystemExit, match="needs a torch.distributed world"):
        train.build_mesh(ns)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
