"""The port's plain kernel versions (``repro_torch.kernels.ref``) against
the JAX Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them.

The port's kernels take ``[k, ...]`` client stacks with ``[k]`` per-client
scalars; a JAX leaf of shape S is compared with the stack ``[1, *S]``, and
a stack of 3 clients with three JAX calls.

Tolerances: masks exact; G, U, V bitwise, except the momentum update
U ← αU + g at α = 0.9, which is held at rtol 1e-5 / atol 1e-6
(tests/test_kernels.py:16). XLA's CPU compiler contracts αU + g into one
fused multiply-add inside the jitted Pallas interpreter, while the port
keeps the multiply and the add apart (as its CUDA kernel does), so the two
can differ by one rounding. Against the JAX package's eager oracle
(``repro.kernels.ref``), which XLA does not fuse, the port is bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import gmf_compress as jgk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.utils import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(5,), (128,), (1000,), (65_536,), (513, 257), (3, 5, 129), (8, 8, 8, 9)]


def _inputs(seed, shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _stack(*xs):
    return [torch.from_numpy(np.asarray(x))[None] for x in xs]


def _row(x):
    return torch.tensor([x], dtype=torch.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.9])
def test_momentum_correction_matches_pallas(shape, alpha):
    u, v, g = _inputs(0, shape)
    uk, vk = jgk.momentum_correction_flat(jnp.asarray(u), jnp.asarray(v), jnp.asarray(g),
                                          alpha, interpret=True)
    ut, vt = tref.momentum_correction_leaf(*_stack(u, v, g), alpha)
    np.testing.assert_allclose(ut[0].numpy(), np.asarray(uk), **TOL)
    np.testing.assert_allclose(vt[0].numpy(), np.asarray(vk), **TOL)
    # bitwise against the unfused eager oracle
    ur, vr = jref.momentum_correction_leaf(jnp.asarray(u), jnp.asarray(v), jnp.asarray(g), alpha)
    assert np.array_equal(ut[0].numpy(), np.asarray(ur))
    assert np.array_equal(vt[0].numpy(), np.asarray(vr))
    if alpha in (0.0, 0.5):  # α·U exact: no rounding for a fused multiply-add to save
        assert np.array_equal(ut[0].numpy(), np.asarray(uk))


@pytest.mark.parametrize("shape", SHAPES)
def test_apply_mask_matches_pallas_bitwise(shape):
    u, v = _inputs(1, shape, 2)
    mask = (np.random.default_rng(2).random(shape) > 0.7).astype(np.float32)
    out_k = jgk.apply_mask_flat(jnp.asarray(u), jnp.asarray(v), jnp.asarray(mask),
                                interpret=True)
    out_t = tref.apply_mask_update_leaf(*_stack(u, v, mask))
    for a, b in zip(out_k, out_t, strict=True):
        assert np.array_equal(b[0].numpy(), np.asarray(a))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tau", [0.0, 0.3, 1.0])
def test_gmf_compress_matches_reference_bitwise(shape, tau):
    """Inputs rounded to 1/16 so many scores tie. With the exact top-10%
    score as threshold (elements sit exactly at it) the port equals the
    eager JAX oracle bitwise. The jitted Pallas interpreter may fuse the
    score into a multiply-add and move a tie by one rounding, so against it
    the threshold sits halfway between two neighbouring distinct scores,
    where no rounding can cross it; there too all four outputs are bitwise."""
    rng = np.random.default_rng(3)
    u, v, m = (np.round(rng.normal(size=shape) * 16) / 16 for _ in range(3))
    u, v, m = (x.astype(np.float32) for x in (u, v, m))
    inv_nv = np.float32(1.0) / (np.float32(np.linalg.norm(v)) + np.float32(1e-16))
    inv_nm = np.float32(1.0) / (np.float32(np.linalg.norm(m)) + np.float32(1e-16))
    tau32 = np.float32(tau)
    kw_t = dict(inv_norm_v=_row(inv_nv), inv_norm_m=_row(inv_nm), tau=_row(tau32))
    kw_j = dict(inv_norm_v=inv_nv, inv_norm_m=inv_nm, tau=jnp.asarray(tau32))
    ts = _stack(u, v, m)
    js = [jnp.asarray(x) for x in (u, v, m)]
    z = tref.gmf_fusion_score(ts[1], ts[2], **kw_t)
    k = max(1, int(np.ceil(0.1 * z.numel())))
    thr = torch.topk(z.reshape(1, -1), k, dim=1).values[:, -1]
    assert int((z == thr).sum()) >= 1
    out_t = tref.gmf_compress_leaf(*ts, threshold=thr, **kw_t)
    out_j = jref.gmf_compress_leaf(*js, threshold=jnp.asarray(thr.numpy()[0]), **kw_j)
    for a, b in zip(out_j, out_t, strict=True):
        assert np.array_equal(b[0].numpy(), np.asarray(a))
    assert int(out_t[3].sum()) >= k

    distinct = torch.unique(z)
    i = int(torch.searchsorted(distinct, thr))
    mid = (distinct[i - 1] + distinct[i]) / 2 if i > 0 else thr / 2
    out_t = tref.gmf_compress_leaf(*ts, threshold=mid.reshape(1), **kw_t)
    out_k = jgk.gmf_compress_flat(*js, threshold=mid.item(), interpret=True, **kw_j)
    for a, b in zip(out_k, out_t, strict=True):
        assert np.array_equal(b[0].numpy(), np.asarray(a))
    assert int(out_t[3].sum()) == int((z >= thr).sum())


def test_client_stack_matches_per_client_pallas():
    """One [3, ...] stack with per-client scalars == three single calls."""
    rng = np.random.default_rng(4)
    shape = (3, 33, 7)
    u, v, m = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    tau, inv_nv, inv_nm = [0.0, 0.4, 1.0], [0.5, 1.0, 2.0], [0.25, 0.5, 3.0]
    thr = [0.2, 0.8, 1.5]
    f = lambda xs: torch.tensor(xs, dtype=torch.float32)
    out_t = tref.gmf_compress_leaf(*(torch.from_numpy(x) for x in (u, v, m)),
                                   inv_norm_v=f(inv_nv), inv_norm_m=f(inv_nm), tau=f(tau),
                                   threshold=f(thr))
    for i in range(3):
        out_k = jgk.gmf_compress_flat(jnp.asarray(u[i]), jnp.asarray(v[i]), jnp.asarray(m[i]),
                                      inv_norm_v=inv_nv[i], inv_norm_m=inv_nm[i], tau=tau[i],
                                      threshold=thr[i], interpret=True)
        for a, b in zip(out_k, out_t, strict=True):
            assert np.array_equal(b[i].numpy(), np.asarray(a))


def test_tail_never_selected():
    """The JAX tail case (tests/test_kernels.py:108): 100 elements, heavily
    padded on the TPU, all selected and nothing past them. The port pads
    nothing; its mask has exactly the 100 elements."""
    n = 100
    ones = torch.ones(1, n)
    g, u2, v2, mask = tref.gmf_compress_leaf(ones, ones, ones, inv_norm_v=_row(0.1),
                                             inv_norm_m=_row(0.1), tau=_row(0.5),
                                             threshold=_row(1e-6))
    out_k = jgk.gmf_compress_flat(jnp.ones(n), jnp.ones(n), jnp.ones(n), inv_norm_v=0.1,
                                  inv_norm_m=0.1, tau=0.5, threshold=1e-6, interpret=True)
    assert g.shape == (1, n) and int(mask.sum()) == n
    for a, b in zip(out_k, (g, u2, v2, mask), strict=True):
        assert np.array_equal(b[0].numpy(), np.asarray(a))


def test_ops_pytree_wrappers_match_pallas_ops():
    """The pytree wrappers, on CPU tensors, against the JAX ``kernels.ops``
    wrappers (Pallas interpret) on the same tree."""
    rng = np.random.default_rng(5)
    tree = lambda: {"a": rng.normal(size=(257,)).astype(np.float32),
                    "nested": {"b": rng.normal(size=(33, 5)).astype(np.float32)}}
    u, v, g = tree(), tree(), tree()
    mask = {"a": (rng.random(257) > 0.5).astype(np.float32),
            "nested": {"b": (rng.random((33, 5)) > 0.5).astype(np.float32)}}
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    to_t = lambda t: jax.tree_util.tree_map(lambda x: torch.from_numpy(x)[None], t)
    for got, want in zip(tops.momentum_correction(to_t(u), to_t(v), to_t(g), 0.5),
                         jops.momentum_correction(to_j(u), to_j(v), to_j(g), 0.5), strict=True):
        assert np.array_equal(got["a"][0].numpy(), np.asarray(want["a"]))
        assert np.array_equal(got["nested"]["b"][0].numpy(), np.asarray(want["nested"]["b"]))
    for got, want in zip(tops.apply_mask_update(to_t(u), to_t(v), to_t(mask)),
                         jops.apply_mask_update(to_j(u), to_j(v), to_j(mask)), strict=True):
        assert np.array_equal(got["a"][0].numpy(), np.asarray(want["a"]))
        assert np.array_equal(got["nested"]["b"][0].numpy(), np.asarray(want["nested"]["b"]))


@pytest.mark.parametrize("alpha", [0.0, 0.9])
def test_ops_momentum_tree_matches_jax_over_resnet56(alpha):
    """The CPU tree path of ``ops.momentum_correction`` over the 169 leaves of
    ResNet-56 (855,578 params) with a client axis of 2, bitwise against the
    JAX package's eager ``momentum_correction`` on the same numpy inputs;
    leaf order and shapes of the outputs follow the input tree."""
    from repro_torch.models import resnet

    shapes = {k: (2, *x.shape) for k, x in
              enumerate(tree_leaves(resnet.init_resnet(torch.Generator().manual_seed(0),
                                                       depth=56)))}
    assert len(shapes) == 169 and sum(int(np.prod(s[1:])) for s in shapes.values()) == 855_578
    rng = np.random.default_rng(7)
    trees = [{f"l{k:03d}": rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    got = tops.momentum_correction(*({k: torch.from_numpy(x) for k, x in t.items()}
                                     for t in trees), alpha)
    want = jref.momentum_correction(*({k: jnp.asarray(x) for k, x in t.items()}
                                      for t in trees), alpha)
    for g, w in zip(got, want, strict=True):
        assert list(g) == sorted(w)
        for k in g:
            assert np.array_equal(g[k].numpy(), np.asarray(w[k]))
