"""The port's config registry and its copies of the reference's config
modules, field for field, and the dense configs the registry adds
(qwen2.5-3b with its QKV bias, yi-34b at 7 query heads per kv head,
command-r-plus-104b) through the port's transformer against the JAX
package's at their ``smoke()`` widths.

Tolerances: per tensor, max |port − JAX| ≤ REL × max |JAX|, REL 1e-5 in
float32 and 3e-2 in bfloat16 (``tests/torch_parity.py``).
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_parity as tp_
import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models import transformer as jtr
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttr
from repro_torch.utils import tree_leaves

DENSE = ("qwen2.5-3b", "yi-34b", "command-r-plus-104b")
SUMMARY = {"mode", "arch", "batch", "prompt_len", "gen", "prefill_ms", "decode_ms",
           "ms_per_step", "tokens_per_s"}


def test_registry_names_every_reference_arch_in_its_order():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_copy_matches_reference(arch):
    tm, jm = tconfigs.ARCHS[arch], jconfigs.ARCHS[arch]
    assert tm.ARCH_ID == jm.ARCH_ID == arch
    assert tm.__name__.startswith("repro_torch.")
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    assert dataclasses.asdict(tconfigs.get_smoke(arch)) == \
        dataclasses.asdict(jconfigs.get_smoke(arch))
    tl, jl = tconfigs.get_long_variant(arch), jconfigs.get_long_variant(arch)
    assert (tl is None) == (jl is None)
    if tl is not None:
        assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    cfg = tconfigs.get_config(arch)
    assert cfg.param_count() == jconfigs.get_config(arch).param_count()
    assert cfg.active_param_count() == jconfigs.get_config(arch).active_param_count()
    assert cfg.layer_types == jconfigs.get_config(arch).layer_types


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_params_tree_matches_reference_layout(arch):
    """The port's init builds the reference's tree, leaf for leaf in shape
    and dtype, for every family."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), param_dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), param_dtype="bfloat16")
    own = ttr.init_params(cfg, torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(lambda k: jtr.init_params(jcfg, k), jax.random.PRNGKey(0))
    jleaves = jax.tree_util.tree_leaves(shapes)
    assert len(tree_leaves(own)) == len(jleaves)
    for got, want in zip(tree_leaves(own), jleaves, strict=True):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_forward_prefill_decode_match(arch, dtype):
    jcfg, tcfg = tp_.configs(jconfigs.ARCHS[arch], tconfigs.ARCHS[arch], dtype)
    jp, tp = tp_.params(jcfg)
    jb, tb = tp_.prompts(jcfg, 2, 20)
    tp_.check_forward(jcfg, tcfg, jp, tp, jb, tb, dtype)
    tp_.check_prefill_decode(jcfg, tcfg, jp, tp, jb, tb, dtype, prompt_len=20, gen=6,
                             cache_len=26)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_serve_runs_every_arch_on_the_cpu(arch, capsys):
    args = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "12", "--gen", "3",
            "--device", "cpu"]
    assert tserve.main(args) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == SUMMARY and summary["arch"] == arch
