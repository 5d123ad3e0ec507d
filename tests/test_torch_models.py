"""The port's ResNet against the JAX package's on params converted from
JAX (HWIO → OIHW), for depths 8 and 14: logits and per-client gradients
(``torch.func.vmap`` of ``torch.func.grad`` against ``jax.vmap`` of
``jax.grad``).

Tolerance: per leaf, max |port − JAX| ≤ 1e-5 × max |JAX| (measured: about
4e-7 for logits and 3e-6 for gradients). Convolutions and GroupNorm
reduce in another order in the two frameworks, so bitwise equality is not
expected.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.fl.tasks import softmax_xent as jxent
from repro.models import resnet as jres
from repro_torch.fl.tasks import softmax_xent as txent
from repro_torch.models import resnet as tres
from repro_torch.utils import flatten_dotted, tree_leaves
from repro_torch.utils.convert import from_jax_params, to_jax_params

REL = 1e-5


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _batch(k=2, b=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, b, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(k, b)).astype(np.int32)
    return x, y


@pytest.fixture(scope="module", params=[8, 14])
def model(request):
    depth = request.param
    jp = jres.init_resnet(jax.random.PRNGKey(depth), depth=depth)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    return depth, jp, np_params, from_jax_params(np_params)


def test_logits_match(model):
    depth, jp, _, tp = model
    x, _ = _batch()
    want = jres.resnet_forward(jp, jnp.asarray(x[0]), depth=depth)
    got = tres.resnet_forward(tp, torch.from_numpy(x[0]), depth=depth)
    assert got.shape == want.shape
    assert _rel_err(got.numpy(), want) <= REL


def test_per_client_grads_match(model):
    depth, jp, _, tp = model
    x, y = _batch()

    def jloss(p, b):
        return jxent(jres.resnet_forward(p, b[0], depth=depth), b[1])

    def tloss(p, b):
        return txent(tres.resnet_forward(p, b[0], depth=depth), b[1])

    jg = jax.vmap(jax.grad(jloss), in_axes=(None, 0))(jp, (jnp.asarray(x), jnp.asarray(y)))
    tg = torch.func.vmap(torch.func.grad(tloss), in_dims=(None, 0))(
        tp, (torch.from_numpy(x), torch.from_numpy(y).long()))
    jflat = flatten_dotted(jax.tree_util.tree_map(np.asarray, jg))
    tflat = flatten_dotted(tg)
    assert sorted(jflat) == sorted(tflat)
    for name, want in jflat.items():
        got = tflat[name].numpy()
        if want.ndim == 5:  # [k, H, W, I, O] -> [k, O, I, H, W]
            want = want.transpose(0, 4, 3, 1, 2)
        assert got.shape == want.shape, name
        assert _rel_err(got, want) <= REL, name


@pytest.mark.parametrize("stride, k, cin, cout", [(1, 3, 4, 8), (2, 3, 4, 8), (2, 1, 4, 8)])
@pytest.mark.parametrize("size", [8, 9])
def test_conv_same_padding(stride, k, cin, cout, size):
    """XLA "SAME" pads a stride-2 3×3 conv by (0, 1), not (1, 1)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, size, size, cin)).astype(np.float32)
    w = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    want = np.asarray(jres._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = tres._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w.transpose(3, 2, 0, 1)), stride)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert _rel_err(got, want) <= REL


def test_groupnorm_population_variance():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 4, 4, 16)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=16).astype(np.float32),
         "bias": rng.normal(size=16).astype(np.float32)}
    want = np.asarray(jres._groupnorm(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))
    gn = tres.GroupNorm(16)
    out = torch.func.functional_call(
        gn, {k: torch.from_numpy(v) for k, v in p.items()},
        (torch.from_numpy(x).permute(0, 3, 1, 2),))
    assert _rel_err(out.permute(0, 2, 3, 1).numpy(), want) <= REL


def test_convert_round_trip_and_init_layout(model):
    depth, _, np_params, tp = model
    back = to_jax_params(tp)
    for a, b in zip(jax.tree_util.tree_leaves(np_params), jax.tree_util.tree_leaves(back),
                    strict=True):
        assert np.array_equal(a, b)
    own = tres.init_resnet(torch.Generator().manual_seed(0), depth=depth)
    assert sorted(flatten_dotted(own)) == sorted(flatten_dotted(tp))
    for a, b in zip(tree_leaves(own), tree_leaves(tp), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = tres.init_resnet(torch.Generator().manual_seed(0), depth=depth)  # repro-noqa: REP001 (the same init twice)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(own), tree_leaves(again),
                                                  strict=True))
