"""The one-device trainer's ``gmf_data`` step (one GMF client, dgcwgmf at rate
0.1) against the JAX package's ``make_train_step`` at ``mesh=None``, for
llama3.2-1b and the MoE, VLM and audio families at ``smoke()`` (the other
five: ``tests/test_torch_train_step_gmf_b.py``), both fed JAX's gradient at
the initial params (``tests/torch_train_parity.py``): the compression, the
server step and the SGD update on equal inputs.

Held: the params, the compression state and the broadcast within 1e-5 of
each leaf's largest magnitude but at boundary flips, and the upload and
download counts within as many entries. Each package sums a leaf's squares
in its own order, so a leaf's norm, and with it every score of the leaf, can
differ by a rounding: two entries whose scores tie at the top-k threshold in
one package may not tie in the other, and one entry is then kept by one side
only. At most 4 such entries a step are allowed (most archs come out
bitwise; command-r-plus-104b's smoke step has one).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_train_parity as tr

FLIPS = 4


@pytest.mark.parametrize("arch", ["llama3.2-1b", "kimi-k2-1t-a32b", "granite-moe-1b-a400m",
                                  "qwen2-vl-72b", "musicgen-large"])
def test_gmf_data_step_on_jax_gradients(arch, monkeypatch):
    jst, tst, ((jm, tm),) = tr.one_step(arch, "gmf_data", jax_grads=monkeypatch)
    up = abs(int(tm["upload_nnz"][0]) - int(np.asarray(jm["upload_nnz"])[0]))
    down = abs(int(tm["download_nnz"]) - int(jm["download_nnz"]))
    assert up <= FLIPS and down <= FLIPS, (arch, up, down)
    flips = tr.boundary_flips(tst.params, jst.params)
    layout = tr.FlatLayout.of(tst.params)
    for field in ("u", "v", "m"):
        flips = max(flips, tr.boundary_flips(layout.unflatten(getattr(tst.cstate, field)),
                                             getattr(jst.cstate, field)))
    flips = max(flips, tr.boundary_flips(layout.unflatten(tst.gbar), jst.gbar))
    assert flips <= FLIPS, (arch, flips)
