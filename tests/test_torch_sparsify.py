"""Top-k selection in the port against the JAX package: thresholds, masks
and nnz are bitwise equal for the exact and the sampled estimator.

The port selects per client row of a ``[k, ...]`` stack; the JAX functions
see one client at a time. The k-th largest value of a multiset does not
depend on the algorithm that finds it, so ``torch.topk`` and
``lax.top_k`` agree exactly.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import fusion as jfusion
from repro.core import sparsify as jsp
from repro.utils import tree_nnz as jtree_nnz
from repro_torch.core import fusion as tfusion
from repro_torch.core import sparsify as tsp
from repro_torch.utils import tree_nnz as ttree_nnz

SHAPES = [(7,), (1000,), (64, 10), (3, 3, 16, 32), (3, 3, 64, 64), (200, 300)]


def _clients(shape, k=3, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k,) + shape).astype(np.float32)
    if ties:
        x = (np.round(x * 4) / 4).astype(np.float32)
    return x


@pytest.mark.parametrize("n, rate", [(1, 0.1), (9, 0.1), (10, 0.1), (36_864, 0.1),
                                     (1000, 0.37), (5, 1.0), (3, 1e-9)])
def test_num_keep_matches(n, rate):
    assert tsp.num_keep(n, rate) == jsp.num_keep(n, rate)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("selector", ["exact", "sampled"])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_mask_bitwise(shape, selector, ties):
    x = _clients(shape, ties=ties)
    got = tsp.topk_mask(torch.from_numpy(x), 0.1, selector)
    for i in range(x.shape[0]):
        want = np.asarray(jsp.topk_mask(jnp.asarray(x[i]), 0.1, selector))
        assert np.array_equal(got[i].numpy(), want)
    assert torch.equal(ttree_nnz({"a": got}, client_axis=True),
                       torch.tensor([int(jtree_nnz({"a": jnp.asarray(got[i].numpy())}))
                                     for i in range(x.shape[0])]))


@pytest.mark.parametrize("shape", SHAPES)
def test_thresholds_bitwise(shape):
    x = np.abs(_clients(shape, seed=1))
    xt = torch.from_numpy(x)
    k = tsp.num_keep(math.prod(shape), 0.1)
    got = tsp.exact_threshold(xt.reshape(x.shape[0], -1), k)
    sample = tsp.strided_sample_nd(xt)
    got_s = tsp.exact_threshold(sample, tsp.num_keep(sample.shape[1], 0.1))
    for i in range(x.shape[0]):
        assert got[i].item() == float(jsp.exact_threshold(jnp.asarray(x[i]).reshape(-1), k))
        js = jsp.strided_sample_nd(jnp.asarray(x[i]))
        assert np.array_equal(sample[i].numpy(), np.asarray(js))
        vals, _ = jax.lax.top_k(js, jsp.num_keep(js.shape[0], 0.1))
        assert got_s[i].item() == float(vals[-1])


def test_global_topk_masks_bitwise():
    """The port's global top-k is ``topk_mask`` over the rows of the flat
    ``[k, N]`` stack: one threshold per client across all leaves."""
    from repro_torch.utils.flat import FlatLayout

    leaves = [_clients(s, seed=i) for i, s in enumerate([(9,), (4, 6), (2, 3, 5)])]
    tree = {f"l{i}": torch.from_numpy(x) for i, x in enumerate(leaves)}
    layout = FlatLayout.of({k: x[0] for k, x in tree.items()})
    got = layout.unflatten(tsp.topk_mask(layout.flatten(tree), 0.2, "exact"))
    for i in range(3):
        want = jsp.global_topk_masks([jnp.asarray(x[i]) for x in leaves], 0.2)
        for g, w in zip(jax.tree_util.tree_leaves(got), want, strict=True):
            assert np.array_equal(g[i].numpy(), np.asarray(w))


def test_tree_nnz_exact_integer_count():
    t = {"a": torch.zeros(2, 5), "b": {"c": torch.ones(2, 3)}}
    t["a"][1, 2] = 4.0
    assert ttree_nnz(t).item() == 7
    assert ttree_nnz(t, client_axis=True).tolist() == [3, 4]
    assert ttree_nnz(t).dtype == torch.int64


@pytest.mark.parametrize("round_idx", [0, 3, 9, 10, 55, 220, 500])
@pytest.mark.parametrize("warmup", [0, 5, 220])
def test_tau_schedule_bitwise(round_idx, warmup):
    got = tfusion.tau_schedule(round_idx, 0.6, warmup)
    want = jfusion.tau_schedule(round_idx, 0.6, warmup)
    assert got.dtype == torch.float32 and got.item() == float(want)


def test_fusion_math_matches():
    x = _clients((4, 33), seed=5)
    got = tfusion.l2_normalize(torch.from_numpy(x))
    for i in range(3):
        want = np.asarray(jfusion.l2_normalize(jnp.asarray(x[i])))
        # one sum of 132 squares, reduced in another order: a few ulps
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-6, atol=0)
    for ls, ms in [(1.0, 1.0), (3.0, 2.0), (0.0, 5.0)]:
        assert tfusion.fednova_step_weight(ls, ms).item() == float(
            jfusion.fednova_step_weight(ls, ms))


def test_tree_l2_norm_matches():
    from repro.utils import tree_l2_norm as jnorm
    from repro_torch.utils import tree_l2_norm as tnorm

    leaves = {"a": _clients((7,), k=1, seed=8)[0], "b": {"c": _clients((4, 5), k=1, seed=9)[0]}}
    got = tnorm(jax.tree_util.tree_map(torch.from_numpy, leaves))
    want = jnorm(jax.tree_util.tree_map(jnp.asarray, leaves))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("up, down", [(100.0, 400.0), (380.0, 400.0), (5.0, 0.0), (77.3, 91.0)])
def test_adaptive_tau_update_bitwise(up, down):
    from repro.core import adaptive as jad
    from repro_torch.core import adaptive as tad

    js, ts = jad.init(0.3), tad.init(0.3)
    for _ in range(3):
        js = jad.update(js, up, down, target_overlap=0.8, eta=0.15, tau_max=0.9)
        ts = tad.update(ts, up, down, target_overlap=0.8, eta=0.15, tau_max=0.9)
        assert float(ts.tau) == float(js.tau)
