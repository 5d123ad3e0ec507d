"""The port's static analysis (``repro_torch.analysis``) against the
reference's ``repro.analysis``.

- Lints: every rule fires exactly at the ``# expect:`` lines of its
  ``tests/analysis_corpus/torch/`` seeded file and is silent on the clean
  twin; REP005 and REP006 give the reference's findings on the reference's
  own corpus pairs; ``# repro-noqa`` scoping (one comment serves both
  packages), REP000 on a syntax error, ``to_json`` byte-equal to the
  reference's; the port's own files are clean.
- Contracts: the port's ``check_all`` on fake CUDA tensors and the
  reference's return the same ``(rule, where)`` set, empty for the shipped
  registry; three stages seeded into both registries (V kept in bf16, the
  download nnz counted in float32, a wire that leaves the broadcast bf16)
  give the same set, the dtype named in each message. Each registry is
  restored after (the port's in its process, the reference's by the
  ``ref_registry`` fixture here).
- Audit: the four pinned configs audit clean on fake CUDA tensors and
  their tallies equal ``collectives_baseline.json``; a missing baseline or
  an extra collective is a JAXPR-BASELINE finding; seeded round fns with
  an ``.item()``, a ``.to("cuda")`` and a bf16 SUM all-reduce raise their
  rules. The dry run and the gate share one ``CollectiveTally``.

The fake-CUDA parts run in one process under the dry run's shim
(``tests/torch_analysis_fake.py``), started with the module beside the
CLI's ``--all`` run, while the rest runs here.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)

from repro.analysis import findings as ref_findings  # noqa: E402
from repro.analysis import lints as ref_lints  # noqa: E402
from repro_torch.analysis import findings as port_findings  # noqa: E402
from repro_torch.analysis import jaxpr_audit, lints  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CORPUS = HERE / "analysis_corpus"
TORCH_CORPUS = CORPUS / "torch"
EXPECT = re.compile(r"#\s*expect:\s*(REP\d+)")
TIMEOUT = 240
SEEDED = {"compensator": "_bf16_v_test", "downlink": "_f32_nnz_test",
          "wire": "_bf16_wire_test"}

_PROCS: dict = {}


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)


@pytest.fixture(scope="module", autouse=True)
def _spawn(tmp_path_factory):
    """Start the shim process and the CLI's ``--all`` run at once: the
    in-process tests run while they work."""
    out = tmp_path_factory.mktemp("analysis") / "fake.json"
    _PROCS["out"] = out
    _PROCS["fake"] = subprocess.Popen(
        [sys.executable, str(HERE / "torch_analysis_fake.py"), str(out)],
        env=_env(**dryrun.tracer_env()), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    _PROCS["cli"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--all"], env=_env(), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield
    for key in ("fake", "cli"):
        if _PROCS[key].poll() is None:
            _PROCS[key].kill()
            _PROCS[key].wait()


def _finish(key):
    proc = _PROCS[key]
    try:
        log = proc.communicate(timeout=TIMEOUT)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, log


@pytest.fixture(scope="module")
def fake():
    rc, log = _finish("fake")
    assert rc == 0, log[-6000:]
    return json.loads(Path(_PROCS["out"]).read_text())


# ---------------------------------------------------------------------------
# Lints
# ---------------------------------------------------------------------------


def _expected_lines(path: Path) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        for rule_id in EXPECT.findall(line):
            out.setdefault(lineno, set()).add(rule_id)
    return out


def _found_lines(linter, path: Path) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for f in linter.lint_source(path.read_text(), str(path)):
        out.setdefault(f.line, set()).add(f.rule)
    return out


def test_rules_keep_the_reference_ids_and_every_rule_has_a_torch_pair():
    assert set(lints.RULES) == set(ref_lints.RULES)
    for rule_id, r in lints.RULES.items():
        assert r.name == ref_lints.RULES[rule_id].name and r.doc and r.history
        assert (TORCH_CORPUS / f"{rule_id.lower()}_bad.py").exists(), rule_id
        assert (TORCH_CORPUS / f"{rule_id.lower()}_ok.py").exists(), rule_id


@pytest.mark.parametrize("rule_id", sorted(lints.RULES))
def test_rule_fires_exactly_at_annotations(rule_id):
    bad = TORCH_CORPUS / f"{rule_id.lower()}_bad.py"
    expected, found = _expected_lines(bad), _found_lines(lints, bad)
    assert expected == found, f"{bad.name}: annotated {expected} but linter found {found}"
    assert {r for rules_ in found.values() for r in rules_} == {rule_id}


@pytest.mark.parametrize("rule_id", sorted(lints.RULES))
def test_clean_twin_is_silent(rule_id):
    ok = TORCH_CORPUS / f"{rule_id.lower()}_ok.py"
    assert not _found_lines(lints, ok), ok.name


@pytest.mark.parametrize("name", ["rep005_bad", "rep005_ok", "rep006_bad", "rep006_ok"])
def test_shared_rules_match_the_reference_on_its_corpus(name):
    path = CORPUS / f"{name}.py"
    src = path.read_text()
    port = [(f.rule, f.line, f.message) for f in lints.lint_source(src, str(path))]
    ref = [(f.rule, f.line, f.message) for f in ref_lints.lint_source(src, str(path))]
    assert port == ref
    assert bool(port) == name.endswith("_bad")


def test_noqa_suppresses_and_scopes_to_rule():
    src = ("import torch\n"
           "def f(info):\n"
           "    a = info.upload_nnz.float()\n"
           "    b = info.upload_nnz.float()  # repro-noqa: REP003 (why)\n"
           "    c = info.upload_nnz.float()  # repro-noqa: REP001\n"
           "    return a, b, c\n")
    assert [f.line for f in lints.lint_source(src, "<noqa>")] == [3, 5]
    bare = src.replace("# repro-noqa: REP001", "# repro-noqa")
    assert [f.line for f in lints.lint_source(bare, "<noqa>")] == [3]


def test_one_suppression_serves_both_packages():
    src = ("import jax.numpy as jnp\n"
           "import numpy as np\n"
           "def f(count, nnz):\n"
           "    return np.float32(count), nnz.astype(jnp.float32)  # repro-noqa: REP003\n"
           "def g(count):\n"
           "    return np.float32(count)\n")
    for linter in (lints, ref_lints):
        assert [(f.rule, f.line) for f in linter.lint_source(src, "<both>")] == [("REP003", 6)]


def test_syntax_error_becomes_rep000_finding():
    assert [f.rule for f in lints.lint_source("def broken(:\n", "<bad>")] == ["REP000"]


@pytest.mark.parametrize("extra", [None, {"families": ["lint"]}])
def test_to_json_is_byte_equal_to_the_reference(extra):
    rows = [("REP001", "x.py", 3, "m", "error"), ("CONTRACT-STATE", "registry:dgc", 0,
                                                  "leaf 0: (1, 36)/float32 -> bfloat16",
                                                  "warning")]
    port = [port_findings.Finding(*r) for r in rows]
    ref = [ref_findings.Finding(*r) for r in rows]
    assert port_findings.to_json(port, extra=extra) == ref_findings.to_json(ref, extra=extra)
    assert port_findings.to_json([]) == ref_findings.to_json([])
    assert [f.format() for f in port] == [f.format() for f in ref]


def test_default_paths_are_the_ports_files():
    paths = {p.relative_to(ROOT).as_posix() for p in lints.default_paths()}
    assert {"src/repro_torch", "chip_smoke.py", "tests/test_torch_analysis.py",
            "tests/torch_analysis_fake.py", "tools/k4_producer_variants.py"} <= paths
    assert not any(p.startswith(("src/repro/", "tests/analysis_corpus")) or p == "src/repro"
                   for p in paths)


def test_port_tree_is_clean():
    found = lints.lint_paths(lints.default_paths())
    assert found == [], "\n".join(f.format() for f in found)


# ---------------------------------------------------------------------------
# Contracts: the port on fake CUDA tensors against the reference
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_registry():
    """The reference's stage and preset registries, restored after the test."""
    from repro.core import registry as reg
    from repro.core import stages

    saved = {kind: dict(names) for kind, names in stages.REGISTRY.items()}
    presets, docs = dict(reg.PRESETS), dict(reg.PRESET_DOCS)
    try:
        yield stages, reg
    finally:
        stages.REGISTRY.clear()
        stages.REGISTRY.update(saved)
        reg.PRESETS.clear()
        reg.PRESETS.update(presets)
        reg.PRESET_DOCS.clear()
        reg.PRESET_DOCS.update(docs)
        reg.resolve.cache_clear()


def _seed_reference(stages, reg):
    """The three broken stages of ``tests/torch_analysis_fake.py``, in the
    reference's registry (JAX trees in place of the port's flat stacks)."""
    import jax.numpy as jnp
    from jax import tree_util

    tree_map = tree_util.tree_map

    @stages.register("compensator", SEEDED["compensator"])
    class _DowncastingEF(stages.Compensator):
        uses_v = True

        def accumulate(self, cfg, ops, u, v, grad, extra):
            v = tree_map(jnp.add, v, grad)
            return v, u, v

        def extract(self, cfg, ops, u, v, value, masks):
            if masks is None:
                g_out, v = v, tree_map(lambda vv: vv * 0.0, v)
            else:
                g_out = tree_map(jnp.multiply, v, masks)
                v = tree_map(lambda vv, mk: vv * (1.0 - mk), v, masks)
            return g_out, u, tree_map(lambda vv: vv.astype(jnp.bfloat16), v)

    @stages.register("downlink", SEEDED["downlink"])
    class _Float32Count(stages.Downlink):
        def apply(self, cfg, wire, residual, bcast, nnz):
            count = jnp.asarray(nnz).astype(jnp.float32)  # repro-noqa: REP003 (the seeded bug)
            return bcast, residual, count

    @stages.register("wire", SEEDED["wire"])
    class _HalfBroadcast(stages.WireCodec):
        def encode(self, cfg, g_out, state, ctx=None):
            return tree_map(lambda g: g.astype(jnp.bfloat16), g_out), state

    reg.register_preset(SEEDED["compensator"],
                        reg.SchemeSpec(selector="topk", compensator=SEEDED["compensator"]))


def _pairs(findings) -> set:
    return {(f[0], f[1]) if isinstance(f, list) else (f.rule, f.path) for f in findings}


def test_contract_parity_on_the_shipped_registry(fake):
    from repro.analysis import contracts as ref_contracts

    assert _pairs(fake["shipped"]) == _pairs(ref_contracts.check_all()) == set()


def test_contract_parity_on_seeded_stages(fake, ref_registry):
    from repro.analysis import contracts as ref_contracts

    _seed_reference(*ref_registry)
    ref = ref_contracts.check_all()
    assert _pairs(fake["seeded"]) == _pairs(ref)
    assert _pairs(ref) >= {("CONTRACT-STATE", "registry:_bf16_v_test"),
                           ("CONTRACT-STATE", "stage:compensator/_bf16_v_test"),
                           ("CONTRACT-COUNT", "stage:downlink/_f32_nnz_test"),
                           ("CONTRACT-WIRE", "stage:wire/_bf16_wire_test")}
    dtype = {"CONTRACT-STATE": "bfloat16", "CONTRACT-VMAP": "bfloat16",
             "CONTRACT-SCAN": "bfloat16", "CONTRACT-COUNT": "float32",
             "CONTRACT-WIRE": "bfloat16"}
    for rule, _, message in fake["seeded"]:
        assert dtype[rule] in message, (rule, message)


def test_registries_are_restored(fake):
    from repro.core import stages

    assert fake["restored"]
    assert SEEDED["compensator"] not in stages.REGISTRY["compensator"]


@pytest.mark.parametrize("n", [1, 37, 4096, 50_001])
def test_sketch_depth_from_the_host_is_the_tables(n):
    """F9: the count sketch's bucket depth, hashed on the host, is the one
    its device tables had read back."""
    from repro_torch.core import sketch

    rows, cols = 5, 97
    idx = torch.arange(n, dtype=torch.int64)
    col = torch.stack([sketch._hash(idx, r, cols) for r in range(rows)])
    counts = torch.zeros(rows, cols, dtype=torch.int64).scatter_add_(1, col,
                                                                    torch.ones_like(col))
    assert sketch._depth(n, rows, cols) == int(counts.max())


# ---------------------------------------------------------------------------
# The round-fn audit and the collective gate
# ---------------------------------------------------------------------------


def test_pinned_configs_audit_clean_and_match_the_committed_baseline(fake):
    audit = fake["audit"]
    assert audit["findings"] == [] and audit["baseline"] == []
    pinned = json.loads(jaxpr_audit.DEFAULT_BASELINE.read_text())["configs"]
    assert audit["reports"] == pinned
    assert set(pinned) == set(jaxpr_audit.AUDITED_CONFIGS)


def test_missing_baseline_is_a_finding(fake, tmp_path):
    out = jaxpr_audit.check_baseline(fake["audit"]["reports"], tmp_path / "nope.json")
    assert [f.rule for f in out] == ["JAXPR-BASELINE"] and "write-baseline" in out[0].message


def test_gate_rejects_an_extra_collective(fake):
    report = dict(fake["audit"]["reports"]["shard_dgcwgmf"])
    report["counts"] = {**report["counts"],
                        "all-reduce": report["counts"].get("all-reduce", 0) + 1}
    report["num_collectives"] += 1
    bad = jaxpr_audit.check_baseline({"shard_dgcwgmf": report})
    assert [f.rule for f in bad] == ["JAXPR-BASELINE"]
    assert bad[0].path == "jaxpr:shard_dgcwgmf" and "analysis-baseline" in bad[0].message


@pytest.mark.parametrize("name,rule", [("item", "JAXPR-CALLBACK"),
                                       ("to_cuda", "JAXPR-TRANSFER"),
                                       ("bf16_sum", "JAXPR-PSUM-DTYPE"),
                                       ("clean", None), ("fine_reduces", None)])
def test_seeded_round_fns(fake, name, rule):
    found = fake["round_fns"][name]
    assert [f[0] for f in found] == ([rule] if rule else [])


def test_tally_records_dtype_and_reduce_op(fake):
    assert fake["round_fns"]["bf16_sum_calls"] == [["all-reduce", "bfloat16", "sum"]]
    assert fake["round_fns"]["fine_reduces_calls"] == [["all-reduce", "bfloat16", "max"],
                                                       ["all-reduce", "int64", "sum"]]


def test_dryrun_and_the_gate_share_the_tally():
    assert dryrun.CollectiveTally is jaxpr_audit.CollectiveTally


def test_host_values_on_the_cpu_cross_nothing():
    """On CPU tensors nothing crosses: a read of a host value is no finding."""
    x = torch.arange(4.0)
    audit = jaxpr_audit.audit_round(lambda x: x * x.sum().item() + x.cpu(), (x,), where="cpu")
    assert audit.findings == [] and audit.host_reads == [] and audit.transfers == []


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args], env=_env(),
                          cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT)


def test_cli_all_exits_zero_on_the_tree():
    rc, log = _finish("cli")
    assert rc == 0, log[-6000:]
    assert log.strip().endswith("0 finding(s), 0 error(s)")


def test_cli_lint_exit_codes(tmp_path):
    proc = _cli("--lint", str(TORCH_CORPUS / "rep004_bad.py"))
    assert proc.returncode == 1 and "REP004" in proc.stdout, proc.stdout + proc.stderr
    out = tmp_path / "report.json"
    proc = _cli("--lint", "--rule", "REP001", "--json", str(out),
                str(TORCH_CORPUS / "rep004_bad.py"), str(TORCH_CORPUS / "rep001_ok.py"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(out.read_text())
    assert payload["ok"] is True and payload["findings"] == []
