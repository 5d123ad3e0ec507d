"""The port's count sketch (``repro_torch.core.sketch``) and FetchSGD
against the JAX package's, on numpy-seeded inputs.

* ``_hash`` and ``_sign`` are uint32 integer maths: bitwise equal for
  every index 0..2²⁰ and near 2³² − 1, at seeds 0..7.
* ``sketch`` sums each bucket one entry at a time in ascending index
  order, the order of JAX's scatter-add on the CPU, so it is held
  **bitwise** (no tolerance is needed: both do the same float32 adds in the
  same order). ``unsketch`` takes ``jnp.median``'s midpoint, so it is
  bitwise too, at odd and even rows.
* ``heavy_hitters`` on a tie-heavy sketch (8 columns, values rounded to
  halves): the indices equal ``lax.top_k``'s (ties to the lower index).
* FetchSGD through ``FLSimulator``, 4 clients, 3 rounds, a 3 × 128
  sketch, from the same params and batches. On a model whose gradient is
  exact elementwise float32 (both packages sketch the same gradients):
  ledger bytes exactly equal round by round (sketch uploads are value
  bytes only; the download is k values with their indices), params and
  the sketch-space state within 1e-5 of each leaf's largest magnitude
  (measured 6e-8: jitted JAX contracts the server's ``β·s_mom + s`` and
  ``s_err + lr·s_mom`` into multiply-adds, ROADMAP R3). On
  ``CifarTask(depth=8)``: ledger bytes exactly equal (the params are not
  comparable there; see that test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import sketch as js
from repro_torch.core import sketch as ts


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", range(8))
def test_hash_and_sign_bitwise(seed):
    idx = np.concatenate([np.arange(2**20), np.arange(2**32 - 4096, 2**32)]).astype(np.int64)
    jidx = jnp.asarray(idx.astype(np.uint32))
    for mod in (7, 128, 20_000):
        assert np.array_equal(np.asarray(js._hash(jidx, seed, mod)),
                              ts._hash(torch.from_numpy(idx), seed, mod).numpy())
    assert np.array_equal(np.asarray(js._sign(jidx, seed)),
                          ts._sign(torch.from_numpy(idx), seed).numpy())


@pytest.mark.parametrize("rows, cols, n", [(5, 200, 30_000), (3, 128, 2_000), (4, 7, 999)])
def test_sketch_bitwise(rows, cols, n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) * np.exp(rng.uniform(-8, 8, size=(3, n)))).astype(np.float32)
    x[:, ::5] = 0.0
    got = ts.sketch(torch.from_numpy(x), rows, cols)
    assert got.shape == (3, rows, cols)
    for r in range(3):
        assert np.array_equal(_bits(js.sketch(jnp.asarray(x[r]), rows, cols)),
                              _bits(got[r].numpy()))
    # one [n] vector sketches to [rows, cols], the same as its row of the stack
    assert torch.equal(ts.sketch(torch.from_numpy(x[1]), rows, cols), got[1])


@pytest.mark.parametrize("rows", [3, 4, 5])
def test_unsketch_bitwise_at_odd_and_even_rows(rows):
    s = np.random.default_rng(rows).normal(size=(rows, 64)).astype(np.float32)
    want = np.asarray(js.unsketch(jnp.asarray(s), 5_000))
    assert np.array_equal(_bits(want), _bits(ts.unsketch(torch.from_numpy(s), 5_000).numpy()))


@pytest.mark.parametrize("rows, k", [(3, 37), (4, 300), (5, 1)])
def test_heavy_hitters_take_jax_indices_on_ties(rows, k):
    # 8 columns of values in halves: thousands of coordinates share each |est|
    s = np.round(np.random.default_rng(k).normal(size=(rows, 8)) * 2) / 2
    s = s.astype(np.float32)
    jv, ji, jd = js.heavy_hitters(jnp.asarray(s), 2_000, k)
    tv, ti, td = ts.heavy_hitters(torch.from_numpy(s), 2_000, k)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(_bits(jv), _bits(tv.numpy()))
    assert np.array_equal(_bits(jd), _bits(td.numpy()))


def test_sketch_is_linear():
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.normal(size=500).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(ts.sketch(x, 5, 200) + 2 * ts.sketch(y, 5, 200),
                               ts.sketch(x + 2 * y, 5, 200), atol=1e-4, rtol=0)


def test_sketch_recovers_heavy_hitters():
    """A 5-sparse signal plus small noise: the top 5 are recovered, their
    values within 20 % (the reference's case)."""
    n, k = 2000, 5
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.01, size=n).astype(np.float32)
    hot = rng.choice(n, k, replace=False)
    x[hot] = rng.choice([-10.0, 10.0], k) * (1 + rng.random(k))
    _, idxs, dense = ts.heavy_hitters(ts.sketch(torch.from_numpy(x), 7, 500), n, k)
    assert set(idxs.tolist()) == set(hot.tolist())
    np.testing.assert_allclose(dense.numpy()[hot], x[hot], rtol=0.2)


# A model whose gradient is exact elementwise float32 (d/dp [Σ p·c + ½ Σ p²]
# = c + p): both packages sketch the same gradients, so the FetchSGD rounds
# differ only by jitted JAX's multiply-adds (ROADMAP R3).
MODEL = {"w": (24, 40), "b": (40,), "h": (40, 7)}
SKETCH = dict(scheme="fetchsgd", sketch_rows=3, sketch_cols=128, sketch_k_frac=0.05)


def _jax_loss(p, batch):
    return sum(jnp.sum(p[n] * batch[n][0]) + 0.5 * jnp.sum(jnp.square(p[n])) for n in MODEL)


def _torch_loss(p, batch):
    return sum(torch.sum(p[n] * batch[n][0]) + 0.5 * torch.sum(torch.square(p[n]))
               for n in MODEL)


def _batches(to):
    def provide(t, ids, rng):
        return {n: to(rng.normal(size=(len(ids), 1, *s)).astype(np.float32))
                for n, s in MODEL.items()}

    return provide


def test_fetchsgd_simulator_matches_jax():
    from repro.core import CompressionConfig as JComp
    from repro.fl import FLConfig as JFL
    from repro.fl import FLSimulator as JSim
    from repro_torch.core import CompressionConfig as TComp
    from repro_torch.fl import FLConfig as TFL
    from repro_torch.fl import FLSimulator as TSim

    fl = dict(num_clients=4, rounds=3, batch_size=1, learning_rate=0.1, seed=0)
    rng = np.random.default_rng(0)
    init = {n: (rng.normal(size=s) * 0.1).astype(np.float32) for n, s in MODEL.items()}
    jsim = JSim(JFL(**fl), JComp(**SKETCH),
                lambda key: {n: jnp.asarray(x) for n, x in init.items()}, _jax_loss)
    jsim.run(_batches(jnp.asarray))
    tsim = TSim(TFL(**fl), TComp(**SKETCH),
                lambda gen: {n: torch.from_numpy(x.copy()) for n, x in init.items()},
                _torch_loss, device="cpu")
    hist = tsim.run(_batches(torch.from_numpy))

    n = tsim.total_params
    assert all(r["upload_nnz"] == [3 * 128] * 4 for r in hist)
    assert all(r["download_nnz"] == int(0.05 * n) for r in hist)
    assert [r["comm_gb"] for r in hist] == [r["comm_gb"] for r in jsim.history]
    assert tsim.ledger.upload_bytes == jsim.ledger.upload_bytes == 3 * 4 * 3 * 128 * 4.0
    assert tsim.ledger.download_bytes == jsim.ledger.download_bytes
    for name in MODEL:
        got, want = tsim.params[name].numpy(), np.asarray(jsim.params[name])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert tsim.cstates == type(tsim.cstates)(u={}, v={}, m={})
    for name in ("s_mom", "s_err"):
        np.testing.assert_allclose(tsim.sstate.momentum[name].numpy(),
                                   np.asarray(jsim.sstate.momentum[name]), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(jsim.sstate.momentum[name])).max())


def test_fetchsgd_resnet8_ledger_matches_jax():
    """FetchSGD on ``CifarTask(depth=8)``, 4 clients, 3 rounds, a 3 × 128
    sketch, through both simulators: the ledger bytes are exactly equal.
    The params are not compared: the port's convolution kernels are OIHW
    and JAX's HWIO, so flat coordinate i is another weight in each package
    and the two sketches (each a valid count sketch of its own vector)
    hash different coordinates together."""
    from repro.core import CompressionConfig as JComp
    from repro.data.synthetic import SynthCIFAR as JData
    from repro.fl import CifarTask as JTask
    from repro.fl import FLConfig as JFL
    from repro.fl import FLSimulator as JSim
    from repro_torch.core import CompressionConfig as TComp
    from repro_torch.data.synthetic import SynthCIFAR as TData
    from repro_torch.fl import CifarTask as TTask
    from repro_torch.fl import FLConfig as TFL
    from repro_torch.fl import FLSimulator as TSim
    from repro_torch.utils.convert import from_jax_params

    fl = dict(num_clients=4, rounds=3, batch_size=8, learning_rate=0.1, seed=0)
    comp = dict(scheme="fetchsgd", sketch_rows=3, sketch_cols=128, sketch_k_frac=0.01)
    jtask = JTask(num_clients=4, depth=8, data=JData(num_train=200, num_test=20))
    ttask = TTask(num_clients=4, depth=8, data=TData(num_train=200, num_test=20), device="cpu")
    jsim = JSim(JFL(**fl), JComp(**comp), jtask.init_fn, jtask.loss_fn)
    np_params = jax.tree_util.tree_map(np.asarray, jsim.params)
    tsim = TSim(TFL(**fl), TComp(**comp), lambda gen: from_jax_params(np_params),
                ttask.loss_fn, device="cpu")
    jsim.run(jtask.batch_provider(8))
    hist = tsim.run(ttask.batch_provider(8))
    assert all(r["upload_nnz"] == [3 * 128] * 4 for r in hist)
    assert all(r["download_nnz"] == int(0.01 * tsim.total_params) for r in hist)
    assert tsim.ledger.upload_bytes == jsim.ledger.upload_bytes
    assert tsim.ledger.download_bytes == jsim.ledger.download_bytes
    assert all(bool(torch.isfinite(x).all()) for x in jax.tree_util.tree_leaves(tsim.params))
    assert tsim.sstate.momentum["s_err"].shape == (3, 128)
