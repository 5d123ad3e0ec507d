"""The one-device trainer (``repro_torch.dist.step``) against the JAX
package's ``make_train_step`` at ``mesh=None`` for each of the ten
architectures at ``smoke()``: one step of ``dense`` and of ``gmf_data``
(one GMF client, dgcwgmf at rate 0.1) on JAX-initialised params and the
same batch, each side with its own gradient.

Tolerances: the loss within 1e-5 relative; ``dense`` params within 1e-5 of
each leaf's largest magnitude and its counts exact. Under ``gmf_data`` the
port keeps at least each leaf's exact top-k and its upload count lies
within 1e-5 relative of JAX's: jitted JAX forms the fusion score with
fused multiply-adds (ROADMAP R3, R5), so an entry that ties the threshold
in one package may not in the other. ``gmf_data``'s params and counts are
held on equal gradients in ``tests/test_torch_train_step_gmf.py``:
with each side's own gradient, which agree to ~1e-6, an entry next to a
leaf's top-k threshold can fall on the other side of it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_train_parity as tr
from repro_torch import configs as tconfigs

ARCHS = list(tconfigs.ARCH_IDS)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_step_matches_jax(arch):
    jst, tst, ((jm, tm),) = tr.one_step(arch, "dense")
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= tr.REL * abs(float(jm["loss"]))
    assert max(tr.leaf_errors(tst.params, jst.params)) <= tr.REL, arch
    for key in ("upload_nnz", "download_nnz", "total_params"):
        assert int(tm[key]) == int(jm[key]), key
    assert tst.step == 1 and tst.cstate.u == {} and tst.gbar == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_gmf_data_step_loss_and_counts_match_jax(arch):
    jst, tst, ((jm, tm),) = tr.one_step(arch, "gmf_data")
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= tr.REL * abs(float(jm["loss"]))
    got, want = int(tm["upload_nnz"][0]), int(np.asarray(jm["upload_nnz"])[0])
    assert abs(got - want) <= 1e-5 * want, (arch, got, want)
    layout = tr.FlatLayout.of(tst.params)
    assert got >= sum(layout.keep(0.1)[0])
    assert tm["upload_nnz"].dtype == torch.int64 and tm["upload_nnz"].shape == (1,)
    assert int(tm["total_params"]) == int(jm["total_params"])
    assert tr.flat_dtypes(tst.cstate) == tr.jax_dtypes(jst.cstate)
