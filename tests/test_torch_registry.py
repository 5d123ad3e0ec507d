"""The port's registry extension API, held by the extension cases of
tests/test_registry.py: custom presets with their docs, duplicate names
refused unless ``override=True``, unknown stage kinds, ``use_kernels``
keeping composed stages, a re-registered preset clearing ``resolve``'s
cache, ``stages.available`` and the ``describe`` listing.

Every test that registers goes through ``port_registry_snapshot``, which
restores the port's ``REGISTRY``, ``PRESETS`` and ``PRESET_DOCS`` and
clears ``resolve``'s cache afterwards."""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread: its docstring)

from repro_torch.core import (
    CompressionConfig,
    SchemeSpec,
    available_presets,
    client_compress,
    init_states,
    register_preset,
    resolve,
)
from repro_torch.core import registry as reg
from repro_torch.core import stages
from repro_torch.utils.flat import FlatLayout

PARAMS = {"w": torch.zeros(8, 16), "b": torch.zeros(16)}
LAYOUT = FlatLayout.of(PARAMS)


@pytest.fixture
def port_registry_snapshot():
    saved_stages = {kind: dict(names) for kind, names in stages.REGISTRY.items()}
    saved_presets, saved_docs = dict(reg.PRESETS), dict(reg.PRESET_DOCS)
    try:
        yield
    finally:
        stages.REGISTRY.clear()
        stages.REGISTRY.update({kind: dict(names) for kind, names in saved_stages.items()})
        reg.PRESETS.clear()
        reg.PRESETS.update(saved_presets)
        reg.PRESET_DOCS.clear()
        reg.PRESET_DOCS.update(saved_docs)
        resolve.cache_clear()


def _grads(seed, k=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(k, LAYOUT.total, generator=gen)


def test_custom_preset_registration(port_registry_snapshot):
    name = "_test_topk_ef"
    register_preset(name, SchemeSpec(selector="topk", compensator="ef"),
                    doc="top-k with plain error feedback (test)")
    assert name in available_presets()
    assert reg.PRESET_DOCS[name] == "top-k with plain error feedback (test)"
    assert resolve(CompressionConfig(scheme=name, rate=0.2)).compensator.name == "ef"
    # the same composition through per-config stage overrides
    cfg = CompressionConfig(scheme="topk", compensator_stage="ef", rate=0.2)
    cs, _ = init_states(cfg, PARAMS)
    cs = type(cs)(*(x.expand(2, -1).clone() if torch.is_tensor(x) else x for x in cs))
    G, cs, info = client_compress(cfg, cs, _grads(0), LAYOUT.zeros(), 0, layout=LAYOUT)
    assert float(cs.v.abs().sum()) > 0  # error feedback engaged: the residual stays in V
    assert info.upload_nnz.tolist() == [26 + 4, 26 + 4]  # ceil(0.2 n) of each leaf


def test_duplicate_registration_raises(port_registry_snapshot):
    with pytest.raises(ValueError, match="override=True"):
        @stages.register("selector", "topk")
        class ShadowTopK(stages.Selector):  # never registered
            pass

    @stages.register("selector", "topk", override=True)
    class ReplacementTopK(stages.Selector):
        pass

    assert isinstance(stages.get_stage("selector", "topk"), ReplacementTopK)
    register_preset("_test_dup", SchemeSpec(selector="topk"))
    with pytest.raises(ValueError, match="override=True"):
        register_preset("_test_dup", SchemeSpec(selector="randomk"))
    register_preset("_test_dup", SchemeSpec(selector="randomk"), override=True)
    assert reg.PRESETS["_test_dup"].selector == "randomk"


def test_register_unknown_stage_kind_raises():
    with pytest.raises(ValueError, match="unknown stage kind"):
        stages.register("not_a_kind", "x")


def test_use_kernels_respects_composed_stages():
    """The fused path implements exactly topk + dgc + gmf: other
    compositions under ``use_kernels`` take the staged path."""
    gbar = LAYOUT.zeros() + 0.05
    g = _grads(1)
    # ef compensator (no U): the kernel path would have sent nothing
    cfg = CompressionConfig(scheme="gmc", fusion_stage="gmf", use_kernels=True)
    cs, _ = init_states(cfg, PARAMS)
    cs = type(cs)(*(x.expand(2, -1).clone() if torch.is_tensor(x) else x for x in cs))
    G, _, info = client_compress(cfg, cs, g, gbar, 0, layout=LAYOUT)
    assert bool((info.upload_nnz > 0).all()) and float(G.abs().sum()) > 0
    # a randomk selector keeps its selection with use_kernels
    for t in range(2):
        outs = []
        for kern in (False, True):
            cfg = CompressionConfig(scheme="dgcwgmf", selector_stage="randomk", rate=0.2,
                                    use_kernels=kern)
            cs, _ = init_states(cfg, PARAMS)
            cs = type(cs)(*(x.expand(2, -1).clone() for x in cs))
            G, _, info = client_compress(cfg, cs, g, gbar, t, layout=LAYOUT)
            outs.append((G, info.upload_nnz))
        (Ga, na), (Gb, nb) = outs
        assert torch.equal(na, nb) and torch.equal(Ga, Gb)


def test_reregistering_preset_invalidates_resolved_schemes(port_registry_snapshot):
    name = "_test_mutable"
    register_preset(name, SchemeSpec(selector="topk"))
    cfg = CompressionConfig(scheme=name)
    assert resolve(cfg).compensator.name == "none"
    register_preset(name, SchemeSpec(selector="topk", compensator="ef"), override=True)
    assert resolve(cfg).compensator.name == "ef"


def test_available_and_describe_list_every_stage_and_preset(capsys):
    assert stages.available("selector") == ("topk", "dense", "randomk", "sketch")
    assert stages.available("rotation") == ("none", "hadamard")
    assert "probquant" in stages.available("wire")
    text = reg.describe()
    for kind in stages.STAGE_KINDS:
        assert f"  {kind}:" in text
    for name in available_presets():
        assert f"  {name} " in text and reg.PRESET_DOCS[name] in text
    assert reg.main() == 0
    assert capsys.readouterr().out.strip() == text.strip()
