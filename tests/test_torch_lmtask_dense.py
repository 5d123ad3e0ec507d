"""``LMTask`` through the port's ``FLSimulator`` against the JAX package's (its
``repro.fl.LMTask`` through ``repro.fl.FLSimulator``), for the dense
architectures: two rounds of dgcwgmf at rate 0.1, 4 clients and 2 a round,
on JAX-initialised params and the same synthetic streams.

JAX runs its rounds eagerly, its client gradients jitted, and the port's
engine is fed those gradients round by round (``tests/torch_train_parity.py``), so everything after the gradient
(the cohorts, the batches, the compression, the aggregation, the server step
and the ledger) is compared on equal inputs: the ledger's bytes are exact
every round, and the params within 1e-5 of each leaf's largest magnitude
(they come out bitwise). The port's own gradients are held against JAX's in
``tests/test_torch_lm_pipeline.py``.
"""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_train_parity as tr


@pytest.mark.parametrize("arch", ['llama3.2-1b', 'command-r-plus-104b', 'yi-34b'])
def test_lmtask_two_rounds_match_jax(arch, monkeypatch):
    tr.check_lmtask(arch, jax_grads=monkeypatch)
