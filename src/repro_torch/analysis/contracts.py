"""Contract checks over the live scheme registry: the port of
``repro.analysis.contracts``.

Every registered preset (and every stage, slotted alone into a neutral
spec) runs through the engine seams of the port's flat API
(``Scheme.init_states``, ``client_compress(..., layout=)``,
``server_aggregate``, ``apply_staleness``) on **fake tensors**
(``FakeTensorMode``, fake CUDA tensors by default: shapes and dtypes, no
storage, no card) inside ``launch.dryrun.fresh_caches()``. Where the
reference traces with ``jax.eval_shape``, the port runs the round itself
on tensors that hold nothing, so the whole registry checks in seconds and
a stage registered at run time that breaks a seam fails here, before any
real run. ``fake=False`` runs the same checks on real tensors (the card's
phase 22 does, at ResNet-56's params).

The rule ids and their meaning are the reference's:

- CONTRACT-TRACE — a raise anywhere;
- CONTRACT-STATE — the ClientState and ServerState fields, keys, shapes
  and dtypes are a fixed point over a round (dtype equality is also the
  no-downcast check of the accumulators);
- CONTRACT-WIRE — the broadcast is float32 for float32 params;
- CONTRACT-COUNT — ``upload_nnz``, ``download_nnz`` and ``union_nnz``
  (and the rate controller's counters) are integer;
- CONTRACT-VMAP — the port writes the client axis out: a ``[3, N]`` client
  stack keeps its fields ``[3, N]`` and its counts ``[3]``;
- CONTRACT-SCAN — the round closes as a carry: (client state, server
  state, broadcast) out of a round are the specs of (client state, server
  state, ``gbar_prev``) into it, and round 2, fed round 1's outputs, runs
  with no host read (on fake tensors a read of a device value raises). A
  round that breaks either cannot be captured as a CUDA graph, which is
  what a scan carry is to XLA; the controller's two updates likewise;
- CONTRACT-RATE — traced ``rates`` / ``wire_levels`` / ``client_ids`` give
  the static path's structure, and the controller's outputs are float32
  rates and integer levels of cohort length;
- CONTRACT-STALENESS — ``apply_staleness`` keeps the buffer.

Analyzers return findings; they never print or exit::

    from repro_torch.analysis import contracts
    findings = contracts.check_all()
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.jaxpr_audit import HostTraffic, _fake_errors, check_can_trace, \
    fake_tensors
from repro_torch.core import stages
from repro_torch.core.registry import PRESETS, Scheme, SchemeSpec, resolve
from repro_torch.core.schemes import CompressionConfig
from repro_torch.core.state import stack_client_states
from repro_torch.utils import tree_leaves, tree_map
from repro_torch.utils.flat import FlatLayout

__all__ = ["check_all", "check_preset", "check_rate_controller", "check_scheme",
           "default_params"]

_NUM_CLIENTS = 3


def default_params(device="cuda"):
    """Tiny two-leaf tree; shapes only matter structurally (made inside the
    caller's tensor mode: fake tensors under ``check_all``)."""
    return {"w": torch.zeros(8, 4, dtype=torch.float32, device=device),
            "b": torch.zeros(4, dtype=torch.float32, device=device)}


def _treedef(tree) -> str:
    """The structure of a state tree: containers and keys, tensors as ``*``."""
    if isinstance(tree, torch.Tensor):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__
        fields = getattr(tree, "_fields", None)
        if fields:
            return f"{name}(" + ", ".join(f"{f}={_treedef(x)}"
                                          for f, x in zip(fields, tree, strict=True)) + ")"
        return f"{name}(" + ", ".join(_treedef(x) for x in tree) + ")"
    return type(tree).__name__


def _leaf(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{tuple(x.shape)}/{str(x.dtype).removeprefix('torch.')}"
    return type(x).__name__


def _diff_trees(expected, got):
    """Human-readable structural diff between two trees of tensors."""
    et, gt = _treedef(expected), _treedef(got)
    if et != gt:
        return f"treedef changed: {et} -> {gt}"
    for i, (e, g) in enumerate(zip(tree_leaves(expected), tree_leaves(got), strict=True)):
        if _leaf(e) != _leaf(g):
            return f"leaf {i}: {_leaf(e)} -> {_leaf(g)}"
    return None


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor) \
        else type(x).__name__


def _is_integer(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.dtype.is_floating_point or x.dtype.is_complex or x.dtype == torch.bool)
    return isinstance(x, int) and not isinstance(x, bool)


def _stacked(tree, n):
    """Zeros of ``tree``'s leaves with a leading axis of ``n``."""
    return tree_map(lambda p: torch.zeros((n,) + tuple(p.shape), dtype=p.dtype,
                                          device=p.device), tree)


def _sum_rows(payload):
    return tree_map(lambda x: torch.sum(x, dim=0), payload)


class _HostRead(Exception):
    """A round read a device value on the host."""


def _guarded(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the host-traffic recorder: raises
    ``_HostRead`` naming the first read (on real tensors too, where the read
    itself does not raise)."""
    traffic = HostTraffic()
    with traffic:
        try:
            out = fn(*args, **kwargs)
        except _fake_errors():
            if not traffic.host_reads:
                raise
    if traffic.host_reads:
        raise _HostRead(traffic.host_reads[0])
    return out


def check_scheme(scheme, *, where: str, params=None, device="cuda") -> list[Finding]:
    """Run one bound :class:`~repro_torch.core.registry.Scheme` through the
    engine seams and return every violated contract as a Finding: on
    ``params`` (the caller's tensors, fake under ``check_all``), else on
    fake ``default_params`` on ``device``."""
    if params is None:
        with _tensors_of(None, device, True) as p:
            return check_scheme(scheme, where=where, params=p)
    findings: list[Finding] = []

    def fail(rule, msg):
        findings.append(Finding(rule, where, 0, msg))

    try:
        cstate, sstate = scheme.init_states(params)
        layout = FlatLayout.of(params)
    except Exception as e:  # noqa: BLE001 — any crash is the finding
        return [Finding("CONTRACT-TRACE", where, 0,
                        f"init_states raised {type(e).__name__}: {e}")]
    one = stack_client_states(cstate, 1)
    grad, gbar = layout.flatten(_stacked(params, 1)), layout.zeros()

    def one_round(cst, sst, g, gb, t, **kw):
        payload, cst, info = scheme.client_compress(cst, g, gb, t, layout=layout, **kw)
        bcast, sst, ainfo = scheme.server_aggregate(sst, _sum_rows(payload),
                                                    float(_NUM_CLIENTS), layout=layout,
                                                    lr=0.1)
        return payload, cst, sst, bcast, info, ainfo

    # -- one round, on fake tensors ---------------------------------------
    try:
        payload, cst2, sst2, bcast, info, ainfo = _guarded(one_round, one, sstate, grad,
                                                           gbar, 0)
    except _HostRead as e:
        fail("CONTRACT-SCAN", f"the round reads the device on the host ({e})")
        return findings
    except Exception as e:  # noqa: BLE001
        fail("CONTRACT-TRACE", f"round trace raised {type(e).__name__}: {e}")
        return findings

    d = _diff_trees(one, cst2)
    if d:
        fail("CONTRACT-STATE", f"ClientState not a fixed point: {d}")
    d = _diff_trees(sstate, sst2)
    if d:
        fail("CONTRACT-STATE", f"ServerState not a fixed point: {d}")

    # the broadcast updates float32 params
    for i, leaf in enumerate(tree_leaves(bcast)):
        if leaf.dtype != torch.float32:
            fail("CONTRACT-WIRE",
                 f"broadcast leaf {i} is {_dtype_name(leaf)}, engines apply it to float32 "
                 f"params — decode before the server step")
            break

    for label, leaf in (("upload_nnz", info.upload_nnz), ("download_nnz", ainfo.download_nnz),
                        ("union_nnz", ainfo.union_nnz)):
        if not _is_integer(leaf):
            fail("CONTRACT-COUNT",
                 f"{label} has dtype {_dtype_name(leaf)}; counters must be integer "
                 f"(float32 is exact only to 2^24)")

    # round 2 takes round 1's outputs verbatim (bcast as gbar_prev), reading
    # nothing back: the round closes as a carry (what a CUDA graph's static
    # buffers need, as lax.scan's carry does)
    d = _diff_trees((one, sstate, gbar), (cst2, sst2, bcast))
    if d:
        fail("CONTRACT-SCAN", f"the round does not close as a carry "
                              f"(client state, server state, broadcast): {d}")
    try:
        _guarded(one_round, cst2, sst2, grad, bcast, 1)
    except _HostRead as e:
        fail("CONTRACT-SCAN", f"round 2 reads the device on the host ({e})")
    except Exception as e:  # noqa: BLE001
        fail("CONTRACT-TRACE", f"round 2 rejects round 1 outputs ({type(e).__name__}: {e})")

    # -- the client axis written out ----------------------------------------
    three = stack_client_states(cstate, _NUM_CLIENTS)
    try:
        _, cst_b, info_b = scheme.client_compress(
            three, layout.flatten(_stacked(params, _NUM_CLIENTS)), gbar, 0, layout=layout)
        d = _diff_trees(three, cst_b)
        if d:
            fail("CONTRACT-VMAP", f"per-client state not preserved over the stack: {d}")
        shape = tuple(getattr(info_b.upload_nnz, "shape", ()))
        if shape != (_NUM_CLIENTS,):
            fail("CONTRACT-VMAP", f"upload_nnz of {_NUM_CLIENTS} clients has shape {shape}")
    except Exception as e:  # noqa: BLE001
        fail("CONTRACT-VMAP", f"client_compress does not take a {_NUM_CLIENTS}-client stack "
                              f"({type(e).__name__}: {e})")

    # -- the dynamic-rate seam ----------------------------------------------
    if scheme.rate_adaptive:
        dev = layout.device
        try:
            pay_d, cst_d, _ = scheme.client_compress(
                one, grad, gbar, 0, rates=torch.full((1,), 0.25, device=dev),
                wire_levels=torch.zeros(1, dtype=torch.int32, device=dev),
                client_ids=torch.zeros(1, dtype=torch.int64, device=dev), layout=layout)
            d = _diff_trees(payload, pay_d)
            if d:
                fail("CONTRACT-RATE", f"dynamic-rate payload structure differs from the "
                                      f"static path: {d}")
            d = _diff_trees(one, cst_d)
            if d:
                fail("CONTRACT-RATE", f"dynamic-rate ClientState not a fixed point: {d}")
        except Exception as e:  # noqa: BLE001
            fail("CONTRACT-RATE", f"client_compress rejects rates/wire_levels/client_ids "
                                  f"({type(e).__name__}: {e})")

    # -- staleness weighting ------------------------------------------------
    if scheme.staleness.name != "none":
        buf = torch.zeros((_NUM_CLIENTS,) + tuple(payload.shape[1:]), dtype=payload.dtype,
                          device=payload.device)
        gaps = torch.zeros(_NUM_CLIENTS, dtype=torch.float32, device=payload.device)
        gmom = layout.zeros() if scheme.staleness_momentum else None
        try:
            d = _diff_trees(buf, scheme.apply_staleness(buf, gaps, gmom))
            if d:
                fail("CONTRACT-STALENESS", f"apply_staleness changed the buffer: {d}")
        except Exception as e:  # noqa: BLE001
            fail("CONTRACT-STALENESS",
                 f"apply_staleness does not run ({type(e).__name__}: {e})")
    return findings


def check_preset(name: str, *, params=None, device="cuda", **cfg_kwargs) -> list[Finding]:
    """Contract-check one registered preset under its default config."""
    cfg = CompressionConfig(scheme=name, rate=0.25, tau=0.3, **cfg_kwargs)
    return check_scheme(resolve(cfg), where=f"registry:{name}", params=params, device=device)


def check_rate_controller(ctrl, cfg, *, where: str, device="cuda") -> list[Finding]:
    """Contract-check one rate-control stage: the state's dtypes, the update
    fixed point, two updates in a row with no host read; on tensors of
    ``device`` made in the caller's tensor mode (``check_all``'s fake one)."""
    findings: list[Finding] = []

    def fail(rule, msg):
        findings.append(Finding(rule, where, 0, msg))

    n, k = 5, _NUM_CLIENTS
    try:
        state = ctrl.init(cfg, n, device)
    except Exception as e:  # noqa: BLE001
        return [Finding("CONTRACT-TRACE", where, 0,
                        f"controller init raised {type(e).__name__}: {e}")]
    if state.ema.dtype != torch.float32:
        fail("CONTRACT-RATE", f"controller EMA is {_dtype_name(state.ema)}; must be float32")
    for label, leaf in (("seen", state.seen), ("rounds", state.rounds)):
        if not _is_integer(leaf):
            fail("CONTRACT-COUNT", f"controller counter {label!r} has dtype "
                                   f"{_dtype_name(leaf)}; counters must be integer")
    ids = torch.arange(k, dtype=torch.int64, device=device)
    vec = torch.zeros(k, dtype=torch.float32, device=device)
    gap = torch.zeros((), dtype=torch.float32, device=device)
    try:
        st2, rates, levels = ctrl.update(cfg, state, ids, vec, vec + 1.0, gap)
    except Exception as e:  # noqa: BLE001
        fail("CONTRACT-TRACE", f"controller update does not run ({type(e).__name__}: {e})")
        return findings
    d = _diff_trees(state, st2)
    if d:
        fail("CONTRACT-STATE", f"controller state not a fixed point: {d}")
    if tuple(rates.shape) != (k,) or rates.dtype != torch.float32:
        fail("CONTRACT-RATE", f"rates must be float32[{k}], got "
                              f"{_dtype_name(rates)}{tuple(rates.shape)}")
    if tuple(levels.shape) != (k,) or not _is_integer(levels):
        fail("CONTRACT-COUNT", f"wire levels must be integer[{k}], got "
                               f"{_dtype_name(levels)}{tuple(levels.shape)}")
    try:
        st = state
        for _ in range(2):
            st, _, _ = _guarded(ctrl.update, cfg, st, ids, vec, vec + 1.0, gap)
    except _HostRead as e:
        fail("CONTRACT-SCAN", f"the controller reads the device on the host ({e})")
    except Exception as e:  # noqa: BLE001
        fail("CONTRACT-SCAN", f"the controller does not close over two updates "
                              f"({type(e).__name__}: {e})")
    return findings


def _stage_probe_spec(kind: str, name: str) -> SchemeSpec:
    """A spec exercising exactly one non-default stage."""
    base = dict(selector="topk", compensator="none", fusion="none", wire="auto",
                rotation="none", downlink="none", staleness="none", rate_control="fixed")
    base[kind] = name
    if kind == "fusion" and name == "gmf":
        base["compensator"] = "dgc"  # gmf scores ride on dgc's U/V seam
    if kind == "rate_control" and name != "fixed":
        base["compensator"] = "dgc"  # give the controller an EF signal seam
    return SchemeSpec(**base)


@contextlib.contextmanager
def _tensors_of(params, device, fake):
    """The params the checks run on: fake tensors on ``device`` (the given
    params' fakes, or ``default_params``) inside a fake mode, or the given
    real ones."""
    if not fake:
        yield default_params(device) if params is None else params
        return
    check_can_trace(device)
    with fake_tensors():
        if params is None:
            yield default_params(device)
        else:
            yield tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype, device=device),
                           params)


def check_all(*, params=None, presets=None, device="cuda", fake=True) -> list[Finding]:
    """Check every registered preset, every stage kind/name, and the
    quantised wire paths, on fake tensors on ``device`` (``fake=False``:
    on ``params`` themselves, real tensors). The CLI calls this."""
    findings: list[Finding] = []
    if params is not None and not fake:
        device = tree_leaves(params)[0].device
    with _tensors_of(params, device, fake) as p:
        for name in (presets if presets is not None else PRESETS):
            findings.extend(check_preset(name, params=p))
        if presets is not None:
            return findings
        for kind in stages.STAGE_KINDS:
            for sname in stages.available(kind):
                cfg = CompressionConfig(scheme="dgcwgmf", rate=0.25, tau=0.3)
                try:
                    scheme = Scheme(cfg, _stage_probe_spec(kind, sname))
                except Exception as e:  # noqa: BLE001
                    findings.append(Finding("CONTRACT-TRACE", f"stage:{kind}/{sname}", 0,
                                            f"stage does not bind: {type(e).__name__}: {e}"))
                    continue
                findings.extend(check_scheme(scheme, where=f"stage:{kind}/{sname}", params=p))
                if kind == "rate_control":
                    findings.extend(check_rate_controller(
                        scheme.rate_control, cfg, where=f"stage:{kind}/{sname}",
                        device=tree_leaves(p)[0].device))
        # a quantised wire must not leak into the accumulators (the state's
        # fixed point in check_scheme); probquant rides the same seam
        for wire in ("bfloat16", "int8", "probquant"):
            findings.extend(check_preset("dgcwgmf", params=p, wire_dtype=wire))
    return findings
