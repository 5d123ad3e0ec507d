"""The PyTorch port stands alone: it imports neither jax, nor the JAX
package, nor msgpack (the checkpoint sidecar is encoded by hand), and its
entry points refuse a CUDA device that is not there. Every public name of
a ported reference module (the serving tier's ``serve/``, the mesh's
``launch/mesh.py`` and ``dist/sharding.py`` among them) exists in the port
or is listed in ``UNPORTED`` with the reason it is not there."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REFERENCE = ROOT / "src" / "repro"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_importing_the_port_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.fl, repro_torch.kernels, "
            "repro_torch.models, repro_torch.data, repro_torch.utils.convert, "
            "repro_torch.configs, repro_torch.dist, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention, repro_torch.models.transformer, "
            "repro_torch.models.lstm, repro_torch.core.rate_control, repro_torch.utils.quant, "
            "repro_torch.fl.availability, repro_torch.core.sketch, repro_torch.utils.draws, "
            "repro_torch.topo, repro_torch.fl.engine, repro_torch.obs, repro_torch.obs.metrics, "
            "repro_torch.optim, repro_torch.checkpoint, repro_torch.launch.train, "
            "repro_torch.data.pipeline, "
            "repro_torch.obs.events, repro_torch.obs.export, repro_torch.obs.report, "
            "repro_torch.obs.trace, repro_torch.obs.health, repro_torch.models.moe, "
            "repro_torch.models.ssm, repro_torch.models.rglru, repro_torch.serve, "
            "repro_torch.serve.cache, repro_torch.serve.engine, repro_torch.launch.mesh, "
            "repro_torch.dist.sharding, repro_torch.analysis, repro_torch.analysis.lints, "
            "repro_torch.analysis.contracts, repro_torch.analysis.jaxpr_audit\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.') or m == 'msgpack')\n"
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


@pytest.mark.parametrize("kw", [
    dict(scheme="topk"), dict(scheme="dgcwgmf_dl"), dict(scheme="adaptive_dgcwgmf"),
    dict(scheme="dgc", wire_dtype="float16"), dict(scheme="dgc", wire_dtype="bfloat16"),
    dict(scheme="dgc", wire_dtype="int8"), dict(scheme="dgc", rate_control_stage="adaptive"),
    dict(scheme="dgc", downlink_stage="topk"),
    dict(scheme="randomk"), dict(scheme="fetchsgd"), dict(scheme="dgc", wire_dtype="probquant"),
    dict(scheme="dgc", selector_stage="randomk"), dict(scheme="dgc", rotation_stage="hadamard"),
    dict(scheme="dgc", selector_stage="sketch"),
    dict(scheme="async_dgcwgmf"), dict(scheme="hier_dgcwgmf"),
    dict(scheme="dgc", tier_scheme="dgc"), dict(scheme="dgc", staleness_stage="poly"),
    dict(scheme="dgc", staleness_stage="gmf_damp"),
])
def test_ported_compression_options_construct(kw):
    from repro_torch.core import CompressionConfig, resolve, resolve_tier

    cfg = CompressionConfig(**kw)
    resolve(cfg)
    resolve_tier(cfg)


@pytest.mark.parametrize("kw", [
    dict(backend="shard"), dict(backend="async"), dict(topology="ring"),
    dict(topology="hierarchical"), dict(delay_model="geometric"), dict(dropout_rate=0.1),
])
def test_ported_fl_options_construct(kw):
    """Each option builds its engine; the shard backend's needs a process
    group, and says so."""
    from repro_torch.core import CompressionConfig
    from repro_torch.fl import FLConfig, make_engine
    from repro_torch.utils.flat import FlatLayout

    fl = FLConfig(num_clients=2, rounds=1, **kw)
    layout = FlatLayout.of({"w": torch.zeros(3)})
    if fl.backend == "shard" and not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            make_engine(fl, CompressionConfig(scheme="dgc"), lambda p, b: 0.0, 2, layout)
    else:
        engine = make_engine(fl, CompressionConfig(scheme="dgc"), lambda p, b: 0.0, 2, layout)
        assert engine.name == (fl.backend if fl.topology == "star" else "topo")


# Public names of a ported reference module that the port does not have:
# (module path, name) -> why.
PALLAS = "a Pallas tiling constant: the CUDA kernels tile otherwise (ROADMAP Queue 2)"
UNPORTED = {
    "core/sparsify.py": {
        "global_topk_masks": "removed on purpose with the flat state: global top-k is "
                             "topk_mask over a client's whole flat row",
        "global_topk_masks_dynamic": "replaced by topk_mask_dynamic over the whole flat row"},
    "kernels/flash_attention.py": {"NEG_INF": PALLAS},
    "kernels/gmf_compress.py": {"BLOCK_ROWS": PALLAS, "LANES": PALLAS, "BLOCK": PALLAS},
    "analysis/jaxpr_audit.py": {
        "COLLECTIVE_RE": "parses XLA's HLO text; the port counts collectives by dispatch: "
                         "CollectiveTally (obs/collectives.py)",
        "SHAPE_RE": "parses XLA's HLO text; the port reads each collective's operand: "
                    "CollectiveTally.calls",
        "parse_collective_bytes": "parses XLA's HLO text; its counterpart is "
                                  "CollectiveTally.summary() (obs/collectives.py)",
        "iter_eqns": "walks a jaxpr; torch has none: HostTraffic and CollectiveTally see "
                     "every op the round fn dispatches",
        "audit_jaxpr": "audits a jaxpr; its counterpart is audit_round (a dispatch mode over "
                       "the round fn)"},
}


def _public_names(path):
    """A module's ``__all__``, else the names its top level defines (no
    imports), without the private ones."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _ported_modules():
    return [p.relative_to(PORT).as_posix() for p in sorted(PORT.rglob("*.py"))
            if (REFERENCE / p.relative_to(PORT)).is_file() and p.name != "__main__.py"]


@pytest.mark.parametrize("rel", _ported_modules())
def test_ported_module_has_every_public_name_of_its_reference(rel):
    """Every public name of a reference module that has a port exists in the
    port, or is listed in ``UNPORTED`` with the ROADMAP item that ports it
    (and a listed name is really missing)."""
    import importlib

    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    port = importlib.import_module(".".join(["repro_torch", *parts]))
    listed = UNPORTED.get(rel, {})
    missing = [n for n in _public_names(REFERENCE / rel) if not hasattr(port, n)]
    assert sorted(set(missing) - set(listed)) == [], f"{rel}: names missing from the port"
    assert sorted(n for n in listed if hasattr(port, n)) == [], f"{rel}: listed but ported"


def test_unported_list_names_only_ported_modules():
    assert set(UNPORTED) <= set(_ported_modules())
