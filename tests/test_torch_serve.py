"""The port's serving entry point and the parameter conversion of the
transformer tree.

``repro_torch.launch.serve.main`` on the CPU prints, as its last line, a
JSON summary with the keys the reference's ``repro.launch.serve`` prints
(the same values where they are not times), in fixed and engine mode.
``from_jax_params`` / ``to_jax_params`` carry the transformer's tree
(tuples, bfloat16 leaves) across bit for bit, and the ResNet's layout
conversion is what it was.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import llama3_2_1b as jllama
from repro.launch import serve as jserve
from repro.models import transformer as jtr
from repro_torch.dist import step as tstep
from repro_torch.kernels import flash_attention as tk4
from repro_torch.launch import serve as tserve
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params, to_jax_params

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2", "--prompt-len", "16",
        "--gen", "4"]
TIMES = {"prefill_ms", "decode_ms", "ms_per_step", "tokens_per_s"}


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_main_prints_the_reference_summary(capsys):
    assert tserve.main([*ARGS, "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert jserve.main(ARGS) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}
    assert all(got[k] > 0 for k in TIMES)


def test_run_fixed_tokens_and_launch_counts_on_cpu():
    args = tserve.parser().parse_args([*ARGS, "--device", "cpu"])
    cfg = tserve.configs.get_smoke(args.arch)
    params = tserve.init_params(cfg, args.seed, "cpu")
    n0 = dict(tk4.LAUNCHES)
    run = tserve.run_fixed(cfg, params, args, torch.device("cpu"))
    assert run.tokens.shape == (2, 4)
    assert run.last_logits.shape == (2, cfg.vocab_size)
    assert tk4.LAUNCHES == n0  # the CPU takes K4's plain version, never the kernel
    again = tserve.run_fixed(cfg, tserve.init_params(cfg, args.seed, "cpu"), args,
                             torch.device("cpu"))
    assert torch.equal(run.tokens, again.tokens)


def test_decode_continues_the_prefill_as_run_fixed_does():
    """``serve.decode``, the loop ``run_fixed`` times, driven on its own from
    the prefill gives ``run_fixed``'s tokens."""
    args = tserve.parser().parse_args([*ARGS, "--device", "cpu"])
    cfg = tserve.configs.get_smoke(args.arch)
    params = tserve.init_params(cfg, args.seed, "cpu")
    run = tserve.run_fixed(cfg, params, args, torch.device("cpu"))
    batch = tserve.prompt_batch(cfg, args.seed, args.batch, args.prompt_len, "cpu")
    logits, cache = tstep.make_prefill_step(cfg, cache_len=args.prompt_len + args.gen)(
        params, batch)
    tok = torch.argmax(logits, dim=-1)
    generated, _ = tserve.decode(tstep.make_serve_step(cfg), params, cache, tok,
                                 torch.tensor(args.prompt_len), args.gen - 1)
    assert len(generated) == args.gen
    assert torch.equal(torch.stack(generated, dim=-1), run.tokens)


ENGINE_TIMES = {"wall_s", "tokens_per_s", "latency_p50_s", "latency_p99_s"}


# The ids are the ones the test had when these options raised naming item 12.
@pytest.mark.parametrize("extra", [["--mode", "engine"], ["--obs", "--mode", "engine"]],
                         ids=["extra0-item 12", "extra1-item 12"])
def test_unported_serving_options_raise(extra, tmp_path, capsys):
    """``--mode engine`` (with and without ``--obs``) is ported: ``main``
    returns 0 on the CPU and its last line has exactly the keys of the
    reference's ``main`` with the same arguments (the keys
    ``chip_smoke.py`` checks on the card), with equal values but the times;
    with ``--obs`` the events file holds ``serve_summary`` and one
    ``serve_request`` per request. (The name is older than the engine's
    port and kept, so the test's history stays one.)"""
    extra = [*extra, "--requests", "3", "--stagger", "1", "--max-slots", "2"]
    obs_dir = tmp_path / "obs"
    if "--obs" in extra:
        extra += ["--obs-dir", str(obs_dir)]
    assert tserve.main([*ARGS, "--device", "cpu", *extra]) == 0
    got = _last_json(capsys.readouterr().out)
    ref = [a for a in extra if a not in ("--obs", "--obs-dir", str(obs_dir))]
    assert jserve.main([*ARGS, *ref]) == 0
    want = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in ENGINE_TIMES} == \
        {k: v for k, v in want.items() if k not in ENGINE_TIMES}
    assert got["mode"] == "engine" and got["requests"] == 3 and got["generated_tokens"] == 12
    # chip_smoke.py's phase 16 holds the card's summary to this key set
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.ENGINE_SUMMARY_KEYS == set(want)
    if "--obs" in extra:
        from repro_torch.obs import events

        assert sorted(os.listdir(obs_dir)) == ["events.jsonl", "metrics.prom", "summary.json"]
        kinds = [e["kind"] for e in events.read_events(str(obs_dir / "events.jsonl"))]
        assert kinds[0] == "run_start" and kinds[-1] == "serve_summary"
        assert kinds.count("serve_request") == 3 and kinds.count("serve_summary") == 1


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "yi-34b"],
                         ids=["granite-moe-1b-a400m-item 12", "yi-34b-item 12"])
def test_unported_archs_raise(arch, capsys):
    """Both archs serve at ``smoke()`` in fixed mode and in engine mode (the
    moe and the dense family's paged pool). (The name is older than the
    archs' port and kept, so the test's history stays one.)"""
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "1",
                        "--prompt-len", "8", "--gen", "2"]) == 0
    assert tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--mode", "engine",
                        "--requests", "2", "--prompt-len", "16", "--gen", "3"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert (got["mode"], got["requests"], got["generated_tokens"]) == ("engine", 2, 6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_tree_round_trips_bitwise(dtype):
    import dataclasses

    cfg = dataclasses.replace(jllama.smoke(), dtype=dtype, param_dtype=dtype)
    np_params = jax.tree_util.tree_map(np.asarray, jtr.init_params(cfg, jax.random.PRNGKey(3)))
    tp = from_jax_params(np_params, layout="transformer")
    assert isinstance(tp["layers"], tuple) and isinstance(tp["tail"], tuple)
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert all(x.dtype == want_dtype for x in tree_leaves(tp))
    back = to_jax_params(tp, layout="transformer")
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(np_params)
    for a, b in zip(jax.tree_util.tree_leaves(np_params), jax.tree_util.tree_leaves(back),
                    strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    # bf16 values arrive exactly: the same float32 numbers on both sides
    for a, t in zip(jax.tree_util.tree_leaves(np_params), tree_leaves(tp), strict=True):
        assert np.array_equal(a.astype(np.float32), t.float().numpy())


def test_resnet_conversion_unchanged():
    rng = np.random.default_rng(0)
    np_params = {"stem": rng.normal(size=(3, 3, 3, 16)).astype(np.float32),  # HWIO
                 "s0b0": {"conv1": rng.normal(size=(3, 3, 16, 16)).astype(np.float32)},
                 "stem_gn": {"scale": np.ones(16, np.float32)},
                 "head": {"kernel": rng.normal(size=(64, 10)).astype(np.float32),
                          "bias": np.zeros(10, np.float32)}}
    tp = from_jax_params(np_params)
    stem = np_params["stem"]
    assert np.array_equal(tp["stem"].numpy(), stem.transpose(3, 2, 0, 1))  # HWIO -> OIHW
    assert np.array_equal(tp["head"]["kernel"].numpy(), np_params["head"]["kernel"])
    back = to_jax_params(tp)
    for a, b in zip(jax.tree_util.tree_leaves(np_params), jax.tree_util.tree_leaves(back),
                    strict=True):
        assert np.array_equal(a, b)
    # the transformer layout leaves 4-D leaves (e.g. stacked expert weights) alone
    w = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    assert np.array_equal(from_jax_params({"w": w}, layout="transformer")["w"].numpy(), w)
    with pytest.raises(ValueError, match="layout"):
        from_jax_params({"w": w}, layout="nchw")


def test_bf16_through_jnp_arrays():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)), jnp.bfloat16)
    t = from_jax_params({"x": (x, [x])}, layout="transformer")
    assert isinstance(t["x"], tuple) and isinstance(t["x"][1], list)
    assert torch.equal(t["x"][0], t["x"][1][0]) and t["x"][0].dtype == torch.bfloat16
    assert np.array_equal(np.asarray(x, np.float32), t["x"][0].float().numpy())
