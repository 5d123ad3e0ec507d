"""The paper's second task in the port against the JAX package: the
SynthShakespeare data, the char-LSTM and ``ShakespeareTask`` on the
simulator.

Tolerances: data, batches, leaf names, shapes and order exact; logits and
per-client gradients through ``vmap(grad)`` within 1e-5 relative of JAX's
on the same params (hidden 32, T 12; the matmuls sum in another order:
measured ~7e-7); three FL rounds of ``dgc`` and ``dgcwgmf`` (5 clients, 2
a round, full width): ledger bytes equal round by round, so the nnz too,
and params within 1e-5 of each leaf's largest magnitude.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import CompressionConfig as JComp
from repro.data.synthetic import SynthShakespeare as JData
from repro.fl import FLConfig as JFL
from repro.fl import FLSimulator as JSim
from repro.fl import ShakespeareTask as JTask
from repro.fl.tasks import softmax_xent as jxent
from repro.models import lstm as jlstm
from repro_torch.core import CompressionConfig as TComp
from repro_torch.data.synthetic import VOCAB
from repro_torch.data.synthetic import SynthShakespeare as TData
from repro_torch.fl import FLConfig as TFL
from repro_torch.fl import FLSimulator as TSim
from repro_torch.fl import ShakespeareTask as TTask
from repro_torch.fl.tasks import softmax_xent as txent
from repro_torch.models import lstm as tlstm
from repro_torch.utils.convert import from_jax_params, to_jax_params
from repro_torch.utils.flat import FlatLayout

REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _small_params(hidden=32):
    p = jlstm.init_lstm(jax.random.PRNGKey(0), vocab=VOCAB, hidden=hidden)
    return p, from_jax_params(jax.tree_util.tree_map(np.asarray, p), layout="lstm")


def test_synth_shakespeare_identical():
    a = JData(num_clients=3, chars_per_client=400, seq_len=80, seed=3)
    b = TData(num_clients=3, chars_per_client=400, seq_len=80, seed=3)
    for k in range(3):
        assert np.array_equal(a.client_tokens[k], b.client_tokens[k])
        for x, y in zip(a.client_sequences(k), b.client_sequences(k), strict=True):
            assert np.array_equal(x, y) and x.dtype == y.dtype
    assert np.array_equal(a.client_char_hist, b.client_char_hist)
    assert a.emd() == b.emd()


def test_params_tree_names_shapes_and_flat_order():
    jp = jlstm.init_lstm(jax.random.PRNGKey(0), vocab=VOCAB)
    tp = tlstm.init_lstm(torch.Generator().manual_seed(0), vocab=VOCAB)
    paths = [jax.tree_util.keystr(path) for path, _ in jax.tree_util.tree_leaves_with_path(jp)]
    layout = FlatLayout.of(tp)
    assert paths == ["['b']", "['embed']", "['head']['bias']", "['head']['kernel']", "['wh']",
                     "['wx']"]
    assert layout.shapes == tuple(x.shape for x in jax.tree_util.tree_leaves(jp))
    assert layout.shapes == ((1024,), (80, 8), (80,), (256, 80), (256, 1024), (8, 1024))
    assert layout.total == 292_560 and layout.num_leaves == 6
    # the conversion keeps every leaf's layout, both ways, bitwise
    back = to_jax_params(from_jax_params(jax.tree_util.tree_map(np.asarray, jp), layout="lstm"),
                         layout="lstm")
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp), strict=True))


def test_logits_match_jax():
    jp, tp = _small_params()
    tokens = np.random.default_rng(0).integers(0, VOCAB, size=(4, 12)).astype(np.int32)
    want = jlstm.lstm_forward(jp, jnp.asarray(tokens))
    got = tlstm.lstm_forward(tp, torch.from_numpy(tokens.astype(np.int64)))
    assert got.shape == (4, 12, VOCAB)
    assert _rel(got.numpy(), want) <= REL


def test_per_client_grads_match_jax():
    """``vmap(grad)`` over 3 clients, as the round engine calls it."""
    jp, tp = _small_params()
    rng = np.random.default_rng(1)
    x = rng.integers(0, VOCAB, size=(3, 4, 12)).astype(np.int32)
    y = rng.integers(0, VOCAB, size=(3, 4, 12)).astype(np.int32)
    jloss = lambda p, b: jxent(jlstm.lstm_forward(p, b[0]), b[1])
    tloss = lambda p, b: txent(tlstm.lstm_forward(p, b[0]), b[1])
    jg = jax.vmap(jax.grad(jloss), in_axes=(None, 0))(jp, (jnp.asarray(x), jnp.asarray(y)))
    tg = torch.func.vmap(torch.func.grad(tloss), in_dims=(None, 0))(
        tp, (torch.from_numpy(x.astype(np.int64)), torch.from_numpy(y.astype(np.int64))))
    for a, b in zip(jax.tree_util.tree_leaves(jg), FlatLayout.of(tp).flatten(tg).split(
            FlatLayout.of(tp).sizes, dim=-1), strict=True):
        assert _rel(b.numpy(), np.asarray(a).reshape(3, -1)) <= REL


def test_task_batches_and_eval_match_jax():
    data_j, data_t = JData(num_clients=4, chars_per_client=400), TData(num_clients=4,
                                                                       chars_per_client=400)
    jtask, ttask = JTask(num_clients=4, data=data_j), TTask(num_clients=4, data=data_t,
                                                           device="cpu")
    assert np.array_equal(ttask.x_test.numpy(), np.asarray(jtask.x_test))
    assert np.array_equal(ttask.y_test.numpy(), np.asarray(jtask.y_test))
    assert ttask.x.dtype == torch.int64 and ttask.measured_emd == jtask.measured_emd
    ra, rb = np.random.default_rng(7), np.random.default_rng(7)
    for batch in (3, 8):  # 8 > 4 sequences a client: drawn with replacement
        for ids in ([0, 2], [1, 2, 3]):
            jb = jtask.batch_provider(batch)(0, ids, ra)
            tb = ttask.batch_provider(batch)(0, ids, rb)
            for a, b in zip(jb, tb, strict=True):
                assert np.array_equal(b.numpy(), np.asarray(a))
    jp = jlstm.init_lstm(jax.random.PRNGKey(1), vocab=VOCAB)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), layout="lstm")
    assert ttask.eval_fn(tp) == jtask.eval_fn(jp)


@pytest.mark.parametrize("scheme, kw", [("dgc", {}), ("dgcwgmf", {"tau": 0.6})])
def test_three_rounds_match_jax(scheme, kw):
    fl = dict(num_clients=5, rounds=3, clients_per_round=2, batch_size=4, learning_rate=0.5,
              seed=0, eval_every=100)
    comp = dict(scheme=scheme, rate=0.1, **kw)
    jtask = JTask(num_clients=5, data=JData(num_clients=5, chars_per_client=400))
    ttask = TTask(num_clients=5, data=TData(num_clients=5, chars_per_client=400), device="cpu")
    jsim = JSim(JFL(**fl), JComp(**comp), jtask.init_fn, jtask.loss_fn)
    np_params = jax.tree_util.tree_map(np.asarray, jsim.params)
    tsim = TSim(TFL(**fl), TComp(**comp), lambda gen: from_jax_params(np_params, layout="lstm"),
                ttask.loss_fn, device="cpu")
    jsim.run(jtask.batch_provider(4))
    tsim.run(ttask.batch_provider(4))
    keep = 29_258  # num_keep over the 6 leaves at rate 0.1
    assert all(r["upload_nnz"] == [keep, keep] for r in tsim.history)
    assert [r["comm_gb"] for r in tsim.history] == [r["comm_gb"] for r in jsim.history]
    for a, b in zip(jax.tree_util.tree_leaves(jsim.params),
                    jax.tree_util.tree_leaves(tsim.params), strict=True):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=REL * np.abs(a).max())
