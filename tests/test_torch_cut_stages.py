"""The pieces the compression stages over leaves cut across a mesh axis are
built from (ROADMAP item 11 part C2b), in one process; the stages
themselves over two ranks are in ``tests/test_torch_tp.py``.

- ``sparsify.group_kth_largest``, the radix select global top-k and the
  distributed heavy hitters run on: without a group, the k-th largest of
  float32 bit patterns bitwise ``torch.topk``'s (normal draws, many ties,
  mostly zeros, all equal; per-row ranks), and of 41-bit index keys;
- ``sharding.boxes``: each leaf's box on a (2, 2) mesh under the FSDP x TP
  specs (some leaves cut on two dims) is where ``chunk`` over the spec's
  axes puts the rank's piece;
- the count sketch's pieces path on a layout that is not cut (the path a
  model past ``TABLE_LIMIT`` takes): ``sketch_pieces``, ``unsketch_pieces``
  and ``hitters_pieces`` bitwise the table path's ``sketch``, ``unsketch``
  and ``heavy_hitters`` on the CPU (``index_add_`` sums each bucket in
  ascending index order there), ties to the lower index; FetchSGD through
  ``Scheme`` with ``TABLE_LIMIT`` 0 bitwise the table path;
- the Hadamard rotation one leaf at a time (``roundtrip_by_leaf``, the path
  of a cut layout and of one past ``PLAN_LIMIT``) bitwise the grouped
  path through ``Scheme.client_compress``, under the float32, int8 and
  probquant wires and with the adaptive controller's wire levels;
- the keyed draws made segment by segment (a cut layout's, and one past
  ``draws.SEGMENT_LIMIT``) bitwise those of the cached positions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)

from repro_torch import configs  # noqa: E402
from repro_torch.core import CompressionConfig, resolve  # noqa: E402
from repro_torch.core import sketch as ts  # noqa: E402
from repro_torch.core import sparsify as tsp  # noqa: E402
from repro_torch.core.state import ClientState  # noqa: E402
from repro_torch.core.stages import HadamardRotation  # noqa: E402
from repro_torch.dist import sharding as shr  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.utils import draws, tree_leaves  # noqa: E402
from repro_torch.utils.flat import FlatLayout  # noqa: E402

SHAPES = {"a": (6, 7, 100), "b": (40,), "c": (96, 50), "d": (3,)}


def _scores(kind, rows, n, seed=0):
    rng = np.random.default_rng(seed)
    z = np.abs(rng.normal(size=(rows, n))).astype(np.float32)
    if kind == "ties":
        z = np.round(z * 4) / 4
    elif kind == "zeros":
        z[:, : n * 9 // 10] = 0.0
    elif kind == "equal":
        z[:] = 1.5
    return torch.from_numpy(z)


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros", "equal"])
def test_radix_select_is_topk(kind):
    z = _scores(kind, 3, 4_000)
    for ks in ([1, 1, 1], [7, 400, 3_999], [4_000, 2_000, 1]):
        k = torch.tensor(ks)
        got = tsp.group_kth_largest(z.view(torch.int32), k, 31).to(torch.int32).view(
            torch.float32)
        want = torch.stack([torch.topk(z[r], ks[r]).values[-1] for r in range(3)])
        assert torch.equal(got, want), (kind, ks)


def test_radix_select_over_index_keys():
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.choice(1 << 41, size=(2, 5_000), replace=False).astype(np.int64))
    for k in (1, 17, 5_000):
        got = tsp.group_kth_largest(keys, torch.tensor([k, k]), 41)
        assert got.tolist() == torch.topk(keys, k, dim=1).values[:, -1].tolist(), k


class _Mesh:
    """The two things ``sharding.boxes`` reads of a mesh: its axes and
    sizes, and this rank's coordinate."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self._coord = shape, names, coord

    def get_coordinate(self):
        return list(self._coord)


@pytest.mark.parametrize("coord", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_boxes_place_the_ranks_pieces(coord):
    cfg = configs.get_smoke("llama3.2-1b")
    mesh = _Mesh((2, 2), ("data", "model"), coord)
    whole = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    specs = shr.param_specs(whole, fsdp=True, mesh=mesh)
    boxes = shr.boxes(whole, specs, mesh)
    at = dict(zip(("data", "model"), coord, strict=True))
    two = 0
    for x, spec, box in zip(tree_leaves(whole), tree_leaves(specs), boxes, strict=True):
        piece = x
        for d, entry in enumerate(spec):
            if entry is not None:
                piece = piece.chunk(2, dim=d)[at[entry]]
        assert box.shape == tuple(x.shape)
        cut = tuple(slice(a, a + e) for a, e in zip(box.start, piece.shape, strict=True))
        assert torch.equal(x[cut], piece)
        two += sum(e is not None for e in spec) == 2
    assert two > 0  # some leaf is cut over both axes


def _layout():
    return FlatLayout.of_sizes([30_000, 7, 12_345], "cpu")


def test_pieces_sketch_is_the_tables_sketch():
    layout = _layout()
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(size=(2, layout.total))
                          * np.exp(rng.uniform(-6, 6, size=(2, layout.total)))).astype(np.float32))
    x[:, ::7] = 0.0
    for rows, cols in ((5, 300), (4, 64)):
        want = ts.sketch(x, rows, cols)
        got = ts.sketch_pieces(x, layout, rows, cols)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (rows, cols)
        assert torch.equal(ts.unsketch_pieces(want[0], layout).view(torch.int32),
                           ts.unsketch(want[0], layout.total).view(torch.int32))


@pytest.mark.parametrize("k", [1, 9, 500, 4_000])
def test_pieces_hitters_take_the_tables_hitters(k):
    """On a tie-heavy sketch (values rounded to halves, 8 columns): the same
    entries, ties to the lower index."""
    layout = _layout()
    rng = np.random.default_rng(k)
    s = torch.from_numpy((np.round(rng.normal(size=(5, 8)) * 2) / 2).astype(np.float32))
    _, _, want = ts.heavy_hitters(s, layout.total, k)
    got = ts.hitters_pieces(s, layout, k)
    assert int(torch.count_nonzero(want)) <= k
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), k


def _run(scheme, layout, grad, gbar, **kw):
    st = ClientState(u=grad * 0.5 if scheme.uses_u else {}, v=grad * 0.25 if scheme.uses_v else {},
                     m={})
    g, new, info = scheme.client_compress(st, grad, gbar, 3, layout=layout, **kw)
    return g, new, info


def test_fetchsgd_pieces_path_is_the_tables_path(monkeypatch):
    layout = _layout()
    cfg = CompressionConfig(scheme="fetchsgd", sketch_cols=500)
    scheme = resolve(cfg)
    rng = np.random.default_rng(3)
    grad = torch.from_numpy(rng.normal(size=(3, layout.total)).astype(np.float32))
    runs = []
    for limit in (ts.TABLE_LIMIT, 0):
        monkeypatch.setattr(ts, "TABLE_LIMIT", limit)
        assert ts.by_pieces(layout, cfg.sketch_rows) == (limit == 0)
        g, _, info = _run(scheme, layout, grad, None)
        _, sst = scheme.init_states({"x": torch.zeros(layout.total)})
        bc, sst, ainfo = scheme.server_aggregate(sst, g.sum(0), 3.0, layout=layout, lr=0.1)
        runs.append((g, bc, sst.momentum["s_err"], info.upload_nnz, ainfo.download_nnz))
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)
    assert int(torch.count_nonzero(runs[0][1])) == int(runs[0][4]) > 0


@pytest.mark.parametrize("wire", ["float32", "int8", "probquant"])
def test_hadamard_by_leaf_is_the_grouped_path(monkeypatch, wire):
    layout = FlatLayout.of({k: torch.zeros(s) for k, s in SHAPES.items()})
    rng = np.random.default_rng(4)
    grad = torch.from_numpy(rng.normal(size=(3, layout.total)).astype(np.float32))
    gbar = torch.zeros(layout.total)
    scheme = resolve(CompressionConfig(scheme="dgc", rotation_stage="hadamard", wire_stage=wire))
    kws = [dict(client_ids=torch.tensor([2, 0, 5])),
           dict(rates=torch.full((3,), 0.1), wire_levels=torch.tensor([1, 0, 1]))]
    for kw in kws:
        runs = []
        for limit in (HadamardRotation.PLAN_LIMIT, 0):
            monkeypatch.setattr(HadamardRotation, "PLAN_LIMIT", limit)
            assert scheme.rotation.by_leaf(layout) == (limit == 0)
            g, new, info = _run(scheme, layout, grad, gbar, **kw)
            runs.append((g, new.u, new.v, info.upload_nnz))
        for a, b in zip(*runs, strict=True):
            assert torch.equal(a, b), (wire, kw)
        assert int(runs[0][3][0]) == sum(1 << (n - 1).bit_length() for n in layout.sizes)


def test_cut_layout_without_boxes_refuses_whole_coordinates():
    """A layout whose pieces' boxes were not given cannot key or cut by the
    whole leaf's coordinates: it says so rather than use the piece's own."""
    layout = FlatLayout.of_sizes([10, 4], "cpu")
    cut = FlatLayout.__new__(FlatLayout)
    cut.__dict__.update(layout.__dict__)
    cut.cut_flags, cut.full_sizes = (True, False), (20, 4)
    with pytest.raises(ValueError, match="boxes"):
        cut.whole_index(0)
    assert cut.whole_index(1).tolist() == [0, 1, 2, 3]


def test_draws_by_segment_are_the_cached_draws(monkeypatch):
    layout = FlatLayout.of({k: torch.zeros(s) for k, s in SHAPES.items()})
    keys = draws.leaf_keys(layout, 29, 4, clients=torch.tensor([0, 7, 3]))
    want = draws.element_hashes(layout, keys)
    monkeypatch.setattr(draws, "SEGMENT_LIMIT", 0)
    assert torch.equal(draws.element_hashes(layout, keys), want)  # repro-noqa: REP001 (the same draws two ways)
    assert want.shape == (3, layout.total)


def test_hadamard_lands_in_the_payloads_dtype(monkeypatch):
    """A bf16 payload's rotated round trip comes back in bf16, as the
    reference's inverse casts to the leaf's dtype, so V keeps its dtype (K2
    on the card takes U and V of one dtype); both paths alike. Under
    ``use_kernels`` K3's mask is in V's dtype, so the payload is bf16 (the
    staged path's float32 mask would promote it)."""
    layout = FlatLayout.of({k: torch.zeros(s, dtype=torch.bfloat16) for k, s in SHAPES.items()})
    rng = np.random.default_rng(5)
    grad = torch.from_numpy(rng.normal(size=(2, layout.total)).astype(np.float32)).bfloat16()
    scheme = resolve(CompressionConfig(scheme="dgc", rotation_stage="hadamard", use_kernels=True))
    runs = []
    for limit in (HadamardRotation.PLAN_LIMIT, 0):
        monkeypatch.setattr(HadamardRotation, "PLAN_LIMIT", limit)
        g, new, _ = _run(scheme, layout, grad, torch.zeros(layout.total, dtype=torch.bfloat16))
        assert g.dtype == new.u.dtype == new.v.dtype == torch.bfloat16
        runs.append((g, new.v))
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)
