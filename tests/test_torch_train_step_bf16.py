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
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_train_parity as tr
from repro_torch.utils import tree_leaves

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
