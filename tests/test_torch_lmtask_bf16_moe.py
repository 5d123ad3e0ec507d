"""``LMTask`` in bfloat16 for the MoE family (granite-moe at ``smoke()`` with
``dtype = param_dtype = "bfloat16"``: bf16 experts beside float32 routers,
two dtype groups) through the port's ``FLSimulator`` against the JAX
package's: the compression state lives in the leaves' own dtypes, as the
reference's does, and promotes as jnp promotes it.

The port is fed JAX's gradients (``tests/torch_train_parity.py``), so the
state's dtypes, its values and the ledger's bytes are held exactly: after
two FL rounds of dgcwgmf the client stacks are bfloat16 (granite's float32
router in a float32 group beside them) and the broadcast float32. The params
differ by design (ROADMAP R13): the reference's float32 learning rate
promotes its params to float32 at the first server step, and the port rounds
each step's float32 result back to the params' dtype, as both packages'
one-device trainers do. So the port's params stay bfloat16 and lie within
two bfloat16 roundings of JAX's: 2**-7 of each leaf's largest magnitude.
"""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_train_parity as tr

ARCHS = ["granite-moe-1b-a400m"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lmtask_bf16_state_dtypes_and_params_match_jax(arch, monkeypatch):
    # the reference's jitted forward refuses float32 params at bf16 (R13):
    # its client gradients run eagerly here
    jsim, tsim = tr.check_lmtask(arch, dtype="bfloat16", jax_grads=monkeypatch,
                                 jit_grads=False)
    assert tr.flat_dtypes(tsim.cstates.v) == (
        ["bfloat16", "float32"] if arch.startswith("granite") else ["bfloat16"])
    assert tsim.ledger.summary() == jsim.ledger.summary()
    for field in ("u", "v", "m"):
        assert max(tr.state_errors(getattr(tsim.cstates, field), tsim.params,
                                   getattr(jsim.cstates, field))) == 0.0, field
    assert max(tr.leaf_errors(tr.FlatLayout.of(tsim.params).unflatten(tsim.gbar_prev),
                              jsim.gbar_prev)) == 0.0
