"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points refuse a CUDA device that is not there."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.fl, repro_torch.kernels, "
            "repro_torch.models, repro_torch.data, repro_torch.utils.convert, "
            "repro_torch.configs, repro_torch.dist, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, repro_torch.models.transformer, "
            "repro_torch.models.lstm, repro_torch.core.rate_control, repro_torch.utils.quant, "
            "repro_torch.fl.availability\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for machines without one")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from repro_torch.core import CompressionConfig
    from repro_torch.data.synthetic import SynthCIFAR, SynthShakespeare
    from repro_torch.fl import CifarTask, FLConfig, FLSimulator, ShakespeareTask

    data = SynthCIFAR(num_train=40, num_test=10)
    with pytest.raises(RuntimeError, match="cuda"):
        CifarTask(num_clients=2, depth=8, data=data)
    task = CifarTask(num_clients=2, depth=8, data=data, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        FLSimulator(FLConfig(num_clients=2, rounds=1), CompressionConfig(scheme="dgc"),
                    task.init_fn, task.loss_fn)
    text = SynthShakespeare(num_clients=2, chars_per_client=200)
    with pytest.raises(RuntimeError, match="cuda"):
        ShakespeareTask(num_clients=2, data=text)
    task = ShakespeareTask(num_clients=2, data=text, device="cpu")
    for scheme in ("dgcwgmf_dl", "adaptive_dgcwgmf"):
        with pytest.raises(RuntimeError, match="cuda"):
            FLSimulator(FLConfig(num_clients=2, rounds=1), CompressionConfig(scheme=scheme),
                        task.init_fn, task.loss_fn)


def test_serve_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    from repro_torch.launch import serve

    assert serve.parser().parse_args(["--arch", "llama3.2-1b"]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama3.2-1b", "--smoke"])


def test_k4_wrapper_takes_plain_only_on_cpu_and_launches_nothing():
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref

    q, k = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    k4.reset_launches()
    assert torch.equal(k4.flash_attention(q, k, k), ref.flash_attention(q, k, k))
    assert k4.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0, "flash_attention_cc": 0}
    with pytest.raises(ValueError, match="cuda"):
        k4._launch_bthd(q, k, k, torch.empty_like(q), True)
    with pytest.raises(ValueError, match="meta"):
        k4.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


def test_kernel_wrappers_refuse_cpu_tensors_and_never_fall_back():
    from repro_torch.kernels import gmf_compress as gk
    from repro_torch.kernels import ops, ref

    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="cuda"):
        gk.momentum_correction_flat(x, x, x, 0.9)
    with pytest.raises(ValueError, match="cuda"):
        gk.apply_mask_flat(x, x, x)
    # ops takes the plain version for CPU tensors only
    got = ops.momentum_correction({"a": x}, {"a": x}, {"a": x}, 0.9)
    want = ref.momentum_correction({"a": x}, {"a": x}, {"a": x}, 0.9)
    assert all(torch.equal(g["a"], w["a"]) for g, w in zip(got, want, strict=True))
    with pytest.raises(ValueError, match="meta"):
        ops.momentum_correction({"a": x.to("meta")}, {"a": x.to("meta")}, {"a": x.to("meta")},
                                0.9)


@pytest.mark.parametrize("kw, match", [
    (dict(scheme="randomk"), "item 8"),
    (dict(scheme="fetchsgd"), "item 8"),
    (dict(scheme="async_dgcwgmf"), "item 9"),
    (dict(scheme="dgc", wire_dtype="probquant"), "item 8"),
    (dict(scheme="dgc", selector_stage="randomk"), "item 8"),
    (dict(scheme="dgc", rotation_stage="hadamard"), "item 8"),
    (dict(scheme="dgc", selector_stage="sketch"), "item 8"),
    (dict(scheme="dgc", tier_scheme="dgc"), "item 9"),
    (dict(scheme="dgc", staleness_stage="poly"), "item 9"),
    (dict(scheme="dgc", staleness_stage="gmf_damp"), "item 9"),
])
def test_unported_compression_options_raise(kw, match):
    from repro_torch.core import CompressionConfig

    with pytest.raises(NotImplementedError, match=match):
        CompressionConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(scheme="topk"), dict(scheme="dgcwgmf_dl"), dict(scheme="adaptive_dgcwgmf"),
    dict(scheme="dgc", wire_dtype="float16"), dict(scheme="dgc", wire_dtype="bfloat16"),
    dict(scheme="dgc", wire_dtype="int8"), dict(scheme="dgc", rate_control_stage="adaptive"),
    dict(scheme="dgc", downlink_stage="topk"),
])
def test_ported_compression_options_construct(kw):
    from repro_torch.core import CompressionConfig, resolve

    resolve(CompressionConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(backend="shard"), dict(backend="async"), dict(topology="ring"),
    dict(topology="hierarchical"), dict(delay_model="geometric"), dict(dropout_rate=0.1),
])
def test_unported_fl_options_raise(kw):
    from repro_torch.fl import FLConfig

    with pytest.raises(NotImplementedError, match="item 9"):
        FLConfig(num_clients=2, rounds=1, **kw)
