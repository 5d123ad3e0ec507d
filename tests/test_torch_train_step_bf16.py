"""The one-device trainer's step in bfloat16 (llama3.2-1b and granite-moe
at ``smoke()`` with ``dtype = param_dtype = "bfloat16"``, gmf_data at one
shard) against the JAX package's, fed JAX's gradient
(``tests/torch_train_parity.py``): params, state and upload counts
exactly (bitwise), the state's dtypes as the reference's. The step keeps bfloat16
params; its state promotes to float32 on the staged path and stays
bfloat16 under ``use_kernels`` (the Pallas kernels write the state's
dtype). Download counts are exact up to ROADMAP R4: XLA flushes subnormal
results to zero and torch keeps them, so the port's broadcast may hold a
few more non-zeros, each a subnormal.

On granite-moe's mixed tree (ROADMAP item 15) the step also runs global
top-k (one threshold over both dtype groups) under dgc and dgcwgmf, and
random-k as a twin fed ``jax.random``'s draws (its draw method serving each
dtype group its leaves' draws): upload counts exact, at most 4 entries of
the params apart (ROADMAP R14), each group's state in the reference's
dtype.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch_train_parity as tr  # noqa: E402
from repro_torch.core import stages  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ARCHS = ["llama3.2-1b", "granite-moe-1b-a400m"]


def _subnormals(flat) -> int:
    tiny = torch.finfo(torch.float32).tiny
    return sum(int(((x != 0) & (x.float().abs() < tiny)).sum()) for x in tree_leaves(flat))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_bf16_matches_jax(arch, use_kernels, monkeypatch):
    jst, tst, ((jm, tm),) = tr.one_step(arch, "gmf_data", dtype="bfloat16",
                                        use_kernels=use_kernels, jax_grads=monkeypatch)
    assert max(tr.leaf_errors(tst.params, jst.params)) == 0.0
    assert tm["upload_nnz"].tolist() == np.asarray(jm["upload_nnz"]).tolist()
    extra = int(tm["download_nnz"]) - int(jm["download_nnz"])
    assert 0 <= extra <= _subnormals(tst.gbar)
    for field in ("u", "v", "m"):
        assert tr.flat_dtypes(getattr(tst.cstate, field)) == tr.jax_dtypes(
            getattr(jst.cstate, field)), field
    assert tr.flat_dtypes(tst.gbar) == tr.jax_dtypes(jst.gbar)
    assert tr.flat_dtypes(tst.params) == tr.jax_dtypes(jst.params)
    for field in ("u", "v", "m"):
        assert max(tr.state_errors(getattr(tst.cstate, field), tst.params,
                                   getattr(jst.cstate, field))) == 0.0, field


GRANITE = "granite-moe-1b-a400m"


def _randomk_twin(monkeypatch, step):
    """Feed the port's random-k selector ``jax.random``'s draws at ``step``
    (the reference's 17 → step → leaf chain), each dtype group its leaves'."""
    from repro.models import transformer as jtr

    cfg = tr.configs(GRANITE, "bfloat16")[0]
    shapes = [x.shape for x in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jtr.init_params(cfg, jax.random.PRNGKey(0))))]
    key = jax.random.fold_in(jax.random.PRNGKey(17), jnp.asarray(step, jnp.int32))
    per_leaf = [np.asarray(jax.random.uniform(jax.random.fold_in(key, i), s)).reshape(-1)
                for i, s in enumerate(shapes)]
    monkeypatch.setattr(stages.get_stage("selector", "randomk"), "uniforms",
                        lambda cfg, r, layout: torch.from_numpy(
                            np.concatenate([per_leaf[i] for i in layout.leaf_ids])))


@pytest.mark.parametrize("scheme, comp_kw", [("dgc", dict(per_tensor=False)),
                                             ("dgcwgmf", dict(per_tensor=False)),
                                             ("randomk", None)],
                         ids=["global-dgc", "global-dgcwgmf", "randomk-twin"])
def test_mixed_tree_gmf_step_matches_jax(monkeypatch, scheme, comp_kw):
    if scheme == "randomk":
        _randomk_twin(monkeypatch, 0)
    jst, tst, ((jm, tm),) = tr.one_step(GRANITE, "gmf_data", dtype="bfloat16", scheme=scheme,
                                        jax_grads=monkeypatch, comp_kw=comp_kw)
    assert tm["upload_nnz"].tolist() == np.asarray(jm["upload_nnz"]).tolist()
    assert tr.boundary_flips(tst.params, jst.params, rel=2.0 ** -7) <= 4
    assert isinstance(tst.cstate.v, tuple)  # one stack per dtype group
    for field in ("u", "v", "m"):
        got = getattr(tst.cstate, field)
        if isinstance(got, tuple):
            assert tr.flat_dtypes(got) == tr.jax_dtypes(getattr(jst.cstate, field)), field
