"""The flat layout of the port's compression state (``repro_torch.utils.flat``)
against the JAX package's trees: leaf order, offsets and keep counts, the
round trip tree -> ``[*lead, N]`` -> tree, and the gather and scatter of
client rows, bitwise.

The port keeps the state of K clients as one client-major ``[K, N]`` stack
whose columns hold the params' leaves one after the other in
``tree_leaves`` order, the JAX package's; the JAX package keeps a tree of
``[K, ...]`` leaves. ResNet-56's convolutions are OIHW in the port and
HWIO in JAX, so their leaves are compared after ``utils.convert``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import sparsify as jsp
from repro.core import state as jstate
from repro_torch.core import state as tstate
from repro_torch.models import resnet
from repro_torch.utils import tree_leaves
from repro_torch.utils.convert import from_jax_params, to_jax_params
from repro_torch.utils.flat import FlatLayout

TOY = {"w": (4, 6), "b": (10,), "nested": {"conv": (2, 3, 3, 5), "gn": {"scale": (16,)}},
       "one": (1,)}


def _toy(lead=(), seed=0):
    rng = np.random.default_rng(seed)

    def build(spec):
        if isinstance(spec, dict):
            return {k: build(v) for k, v in spec.items()}
        return torch.from_numpy(rng.normal(size=lead + spec).astype(np.float32))

    return build(TOY)


def _resnet56():
    return resnet.init_resnet(torch.Generator().manual_seed(0), depth=56)


TREES = {"resnet56": _resnet56, "toy": _toy}


@pytest.mark.parametrize("name", TREES)
def test_layout_follows_tree_leaves(name):
    params = TREES[name]()
    layout = FlatLayout.of(params)
    leaves = tree_leaves(params)
    assert layout.shapes == tuple(tuple(x.shape) for x in leaves)
    assert layout.sizes == tuple(x.numel() for x in leaves)
    assert layout.offsets[0] == 0 and layout.total == sum(layout.sizes)
    assert all(b - a == n for a, b, n in zip(layout.offsets, layout.offsets[1:], layout.sizes))
    assert layout.offsets_dev.tolist() == list(layout.offsets)
    assert layout.offsets_dev.dtype == torch.int64
    if name == "resnet56":
        assert layout.num_leaves == 169 and layout.total == 855_578
        # the JAX package orders the same tree's leaves the same way
        jleaves = jax.tree_util.tree_leaves(to_jax_params(params))
        assert [math.prod(x.shape) for x in jleaves] == list(layout.sizes)


@pytest.mark.parametrize("lead", [(), (1,), (3,), (2, 3)])
@pytest.mark.parametrize("name", TREES)
def test_layout_round_trip(name, lead):
    params = TREES[name]()
    layout = FlatLayout.of(params)
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(rng.normal(size=lead + tuple(x.shape)).astype(np.float32)),
        params)
    flat = layout.flatten(tree)
    assert flat.shape == lead + (layout.total,)
    for seg, x in zip(layout.segments(flat), tree_leaves(tree), strict=True):
        assert torch.equal(seg, x.reshape(*lead, -1))
    back = layout.unflatten(flat)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(tree_leaves(back), tree_leaves(tree), strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    # views: a write through the tree shows in the flat tensor
    tree_leaves(back)[-1].fill_(7.0)
    assert bool((flat[..., layout.offsets[-2]:] == 7.0).all())


def test_layout_is_cached_per_structure_and_shape():
    a, b = FlatLayout.of(_toy()), FlatLayout.of(_toy(seed=5))
    assert a is b
    other = _toy()
    other["b"] = torch.zeros(11)
    assert FlatLayout.of(other) is not a
    assert FlatLayout.of({"x": torch.zeros(3)}) is not FlatLayout.of({"y": torch.zeros(3)})


@pytest.mark.parametrize("rate", [0.1, 0.37, 1.0])
def test_keep_counts_match_jax_per_leaf(rate):
    layout = FlatLayout.of(_resnet56())
    host, dev = layout.keep(rate)
    assert host == tuple(jsp.num_keep(n, rate) for n in layout.sizes)
    assert dev.dtype == torch.int64 and dev.tolist() == list(host)
    assert layout.keep(rate)[1] is dev  # made once per rate
    if rate == 0.1:
        assert sum(host) == 85_654


def test_expand_repeats_each_leaf_value_over_its_columns():
    layout = FlatLayout.of(_toy())
    per_leaf = torch.arange(2 * layout.num_leaves, dtype=torch.float32).reshape(2, -1)
    got = layout.expand(per_leaf)
    assert got.shape == (2, layout.total)
    for i, seg in enumerate(layout.segments(got)):
        assert bool((seg == per_leaf[:, i:i + 1]).all())


@pytest.mark.parametrize("fields", [(True, True, True), (True, True, False),
                                    (False, True, False), (False, False, False)])
def test_gather_scatter_match_jax_trees(fields):
    """The port's one-op-per-field gather and scatter on the flat ``[K, N]``
    stacks against the JAX package's tree functions, bitwise, through two
    rounds of partial participation."""
    K = 6
    params = _toy()
    layout = FlatLayout.of(params)
    rng = np.random.default_rng(2)

    def tree_stack(n):
        return jax.tree_util.tree_map(
            lambda x: rng.normal(size=(n,) + tuple(x.shape)).astype(np.float32), params)

    use = dict(zip(("u", "v", "m"), fields))
    jstates = jstate.ClientState(**{f: tree_stack(K) if on else {} for f, on in use.items()})
    jstates = jax.tree_util.tree_map(jnp.asarray, jstates)
    flat = lambda st: type(st)(*(layout.flatten(jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)), f)) if jax.tree_util.tree_leaves(f) else f
        for f in st))
    tstates = flat(jstates)
    for idx in ([0, 2, 5], [1, 2, 3, 4]):
        jgot = jstate.gather_client_states(jstates, jnp.asarray(idx))
        tgot = tstate.gather_client_states(tstates, torch.tensor(idx))
        for a, b in zip(tgot, flat(jgot), strict=True):
            assert a == b == {} if isinstance(a, dict) else torch.equal(a, b)
        upd = jstate.ClientState(**{f: tree_stack(len(idx)) if on else {}
                                    for f, on in use.items()})
        upd = jax.tree_util.tree_map(jnp.asarray, upd)
        jstates = jstate.scatter_client_states(jstates, jnp.asarray(idx), upd)
        out = tstate.scatter_client_states(tstates, torch.tensor(idx), flat(upd))
        for a, b, c in zip(out, flat(jstates), tstates, strict=True):
            assert a == b == {} if isinstance(a, dict) else (torch.equal(a, b) and a is c)


def test_init_and_stack_client_states_are_flat():
    params = from_jax_params(to_jax_params(_toy()))
    layout = FlatLayout.of(params)
    one = tstate.init_client_state(params, use_u=True, use_v=False, use_m=True)
    assert one.v == {} and one.u.shape == (layout.total,) and one.u.dtype == torch.float32
    stacked = tstate.stack_client_states(one, 4)
    assert stacked.u.shape == (4, layout.total) and stacked.u.is_contiguous()
    stacked.u[1].fill_(1.0)  # rows own their storage
    assert float(stacked.u[0].abs().sum()) == 0.0
