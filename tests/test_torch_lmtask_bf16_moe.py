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

The same tree through the async engine (stragglers: geometric delays,
dropout, a buffer of 2) and the hierarchical topology (2 groups,
hier_dgcwgmf), ROADMAP item 15, held the same way: the ledger exact (and
the async schedule), params within 2**-7, the state's dtypes the
reference's, the held-out loss within BF16_REL. Both runs start in one
module fixture, after this file's first test has warmed the reference's
eager op caches.
"""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

import torch_train_parity as tr  # noqa: E402

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


GRANITE = "granite-moe-1b-a400m"
ENGINE_RUNS = {
    "async": (dict(backend="async", delay_model="geometric", delay_mean=1.0, delay_max=3,
                   dropout_rate=0.2, buffer_size=2, rounds=5), None),
    "hierarchical": (dict(topology="hierarchical", groups=2), dict(scheme="hier_dgcwgmf")),
}


@pytest.fixture(scope="module")
def engine_runs():
    """Each ENGINE_RUNS entry through both packages' ``FLSimulator``."""
    out = {}
    for name, (fl_kw, comp_kw) in ENGINE_RUNS.items():
        with pytest.MonkeyPatch.context() as mp:
            out[name] = tr.run_lmtask(GRANITE, dtype="bfloat16", jax_grads=mp, jit_grads=False,
                                      fl_kw=fl_kw, comp_kw=comp_kw)
    return out


@pytest.mark.parametrize("name", list(ENGINE_RUNS))
def test_lmtask_bf16_mixed_tree_engines_match_jax(engine_runs, name):
    jsim, tsim, jtask, ttask = engine_runs[name]
    assert tsim.engine.name == {"async": "async", "hierarchical": "topo"}[name]
    assert tr.flat_dtypes(tsim.cstates.v) == ["bfloat16", "float32"]
    assert tsim.ledger.summary() == jsim.ledger.summary()
    if name == "async":
        for key in ("applies", "pending", "in_flight"):
            assert [r.get(key) for r in tsim.history] == [r.get(key) for r in jsim.history]
        assert sum(r["applies"] for r in tsim.history) >= 2
    else:
        assert [r["comm_gb"] for r in tsim.history] == [r["comm_gb"] for r in jsim.history]
    assert max(tr.leaf_errors(tsim.params, jsim.params, dtypes=False)) <= 2.0 ** -7
    for field in ("u", "v", "m"):
        assert tr.flat_dtypes(getattr(tsim.cstates, field)) == tr.jax_dtypes(
            getattr(jsim.cstates, field)), field
    assert tr.flat_dtypes(tsim.gbar_prev) == tr.jax_dtypes(jsim.gbar_prev)
    with jax.disable_jit():  # the reference's scan refuses float32 params at bfloat16
        jl = float(jtask.loss_fn(jsim.params, jtask.held_out))
    tl = ttask.held_out_loss(tsim.params)
    assert abs(tl - jl) <= tr.BF16_REL * abs(jl), (name, tl, jl)
