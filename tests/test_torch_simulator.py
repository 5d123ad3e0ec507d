"""The port's FL round end to end against the JAX package's: the same
SynthCIFAR arrays, the same cohorts and batches from the same numpy rng,
and after two rounds of ``dgcwgmf`` on ``CifarTask(depth=8)`` with 4
clients (3 sampled per round), the same per-client upload nnz, ledger and
params.

Tolerances: data, cohorts, batches and per-client nnz exact; ledger totals
within 0.1 % (a boundary mask flip would move the download union by an
element); params within 1e-5 of each leaf's largest magnitude (measured:
about 1e-6; gradients agree to ~3e-6, tests/test_torch_models.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")

from repro.core import CompressionConfig as JComp
from repro.data import partition as jpart
from repro.data.synthetic import SynthCIFAR as JData
from repro.fl import CifarTask as JTask
from repro.fl import FLConfig as JFL
from repro.fl import FLSimulator as JSim
from repro_torch.core import CompressionConfig as TComp
from repro_torch.core.accounting import CommLedger, CostModel
from repro_torch.data import partition as tpart
from repro_torch.data.synthetic import SynthCIFAR as TData
from repro_torch.fl import CifarTask as TTask
from repro_torch.fl import FLConfig as TFL
from repro_torch.fl import FLSimulator as TSim
from repro_torch.utils.convert import from_jax_params, to_jax_params

FL = dict(num_clients=4, rounds=2, clients_per_round=3, batch_size=8, learning_rate=0.1,
          seed=0)
COMP = dict(scheme="dgcwgmf", rate=0.1, tau=0.6)


def test_synth_cifar_and_partition_identical():
    a, b = JData(num_train=300, num_test=50, seed=3), TData(num_train=300, num_test=50, seed=3)
    for name in ("prototypes", "x_train", "y_train", "x_test", "y_test"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    for emd in (0.0, 0.76, 1.35):
        d = jpart.client_label_distributions(7, 10, emd)
        assert np.array_equal(d, tpart.client_label_distributions(7, 10, emd))
        pa = jpart.partition_by_distribution(a.y_train, d, 1)
        pb = tpart.partition_by_distribution(b.y_train, d, 1)
        assert all(np.array_equal(x, y) for x, y in zip(pa, pb, strict=True))


@pytest.mark.parametrize("nnz, down, total, k", [
    ([7798, 7798, 7798], 20000, 77850, 3), ([0, 5], 0, 10, 2), ([9, 10], 10, 10, 2),
    ([2**31 + 7], 2**33, 10**10, 1)])
def test_ledger_matches(nnz, down, total, k):
    from repro.core import CommLedger as JLedger

    ja, ta = JLedger(), CommLedger(CostModel())
    for _ in range(3):
        ja.record_round(np.asarray(nnz), float(down), total, k)
        ta.record_round(np.asarray(nnz), float(down), total, k)
    js, ts = ja.summary(), ta.summary()
    for key in ("rounds", "upload_gb", "download_gb", "total_gb"):
        assert js[key] == ts[key], key


def test_two_rounds_match_jax():
    jdata, tdata = JData(num_train=300, num_test=50), TData(num_train=300, num_test=50)
    jtask = JTask(num_clients=4, depth=8, data=jdata)
    ttask = TTask(num_clients=4, depth=8, data=tdata, device="cpu")
    jsim = JSim(JFL(**FL), JComp(**COMP), jtask.init_fn, jtask.loss_fn)
    np_params = jax.tree_util.tree_map(np.asarray, jsim.params)
    tsim = TSim(TFL(**FL), TComp(**COMP), lambda gen: from_jax_params(np_params),
                ttask.loss_fn, device="cpu")

    seen = {"jax": [], "port": []}

    def record(provide, tag):
        def f(t, ids, rng):
            batch = provide(t, ids, rng)
            seen[tag].append((np.asarray(ids), np.asarray(batch[0]), np.asarray(batch[1])))
            return batch
        return f

    jnnz = []
    jround = jsim._round_fn

    def jround_rec(*args):
        out = jround(*args)
        jnnz.append([int(x) for x in np.asarray(out[4])])
        return out

    jsim._round_fn = jround_rec
    jsim.run(record(jtask.batch_provider(8), "jax"))
    hist = tsim.run(record(ttask.batch_provider(8), "port"))

    for (ja, jx, jy), (ta, tx, ty) in zip(seen["jax"], seen["port"], strict=True):
        assert np.array_equal(ja, ta) and np.array_equal(jx, tx) and np.array_equal(jy, ty)
    assert hist[0]["upload_nnz"] == jnnz[0]
    js, ts = jsim.ledger.summary(), tsim.ledger.summary()
    for key in ("upload_gb", "download_gb", "total_gb"):
        assert abs(ts[key] - js[key]) <= 1e-3 * js[key], key
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jsim.params))
    tp = jax.tree_util.tree_leaves(to_jax_params(tsim.params))
    for a, b in zip(jp, tp, strict=True):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()
