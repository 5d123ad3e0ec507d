"""Round-fn audit and collective gate: the port of ``repro.analysis.jaxpr_audit``.

Torch has no jaxpr: the port audits a round fn by dispatch. The function
the engine hands the simulator (``RoundEngine.round_fn``, the one
``FLSimulator`` calls) runs under a ``TorchDispatchMode`` that sees every
op it issues, on fake CUDA tensors (``FakeTensorMode``: shapes, no storage,
no card) or on real ones. Three questions, with the reference's rule ids:

1. **Is anything escaping the device?** JAXPR-CALLBACK for a host read: an
   op whose output depends on a device value's data
   (``aten._local_scalar_dense`` behind ``.item()`` / ``float()`` /
   ``bool()``, the data-dependent shapes of ``nonzero`` and the like), or a
   copy from the device to the CPU. JAXPR-TRANSFER for a copy from the
   CPU to the device inside the fn. On fake tensors a host read raises
   once its op is recorded; the audit stops there.
2. **Is any SUM collective reducing half precision?** JAXPR-PSUM-DTYPE for
   a SUM all-reduce or reduce-scatter of a float16/bfloat16 operand
   (integer counters are exact and fine).
3. **How many collectives does each pinned config issue?** Counted by
   ``obs.collectives.CollectiveTally`` (the tally ``launch/dryrun.py``
   keeps: the dry run and the gate count with one class) and held
   against the committed ``collectives_baseline.json`` beside this file
   (JAXPR-BASELINE); an intentional change regenerates it with
   ``python -m repro_torch.analysis --jaxpr --write-baseline``.

The pinned configs are the reference's four, on its linear-softmax task
(12 → 4): ``vmap_dgcwgmf`` needs no process group; ``shard_dgcwgmf``,
``shard_none`` and ``ring_dgcwgmf`` run in a fake world of 8 or 4 ranks
(``torch.testing``'s fake process group), this process rank 0, torn down
after each. Each config runs one round first, unaudited (it builds the
layout's caches: keep tables, the select plan), then audits round 2 fed
round 1's outputs. The topology engine's one read of its counts lies in
``topo_round``, outside ``round_fn``, as the reference's host loop does.

Fake CUDA tensors need a build of PyTorch with CUDA, or the shim of
``launch/dryrun.py`` preloaded (``dryrun.tracer_env()``); the CLI re-runs
itself under it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.findings import Finding
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import _tensors
from repro_torch.obs.collectives import CollectiveTally

# -- recording a round ----------------------------------------------------------

_HALF_DTYPES = ("float16", "bfloat16")
_REDUCE_KINDS = ("all-reduce", "reduce-scatter")


def _on_device(t: torch.Tensor) -> bool:
    return t.device.type not in ("cpu", "meta")


class HostTraffic(TorchDispatchMode):
    """Records the ops that cross between the host and the device: host
    reads (``host_reads``) and host-to-device copies (``transfers``), each
    as ``"op (src -> dst)"``. An op is recorded before it runs, so a host
    read that raises on a fake tensor is recorded all the same."""

    def __init__(self):
        super().__init__()
        self.host_reads: list[str] = []
        self.transfers: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        ins = _tensors(list(args) + list(kwargs.values()))
        if name == "aten::_to_copy" and ins:
            dst = torch.device(kwargs.get("device") or ins[0].device)
            self._copy(name, ins[0].device, dst)
        elif name == "aten::copy_" and len(ins) >= 2:
            self._copy(name, ins[1].device, ins[0].device)
        elif any(_on_device(t) for t in ins) and _reads_data(func, args, kwargs):
            self.host_reads.append(f"{name} (data-dependent, on {ins[0].device.type})")
        return func(*args, **kwargs)

    def _copy(self, name, src: torch.device, dst: torch.device) -> None:
        if src.type == dst.type:
            return
        if dst.type == "cpu" and src.type != "meta":
            self.host_reads.append(f"{name} ({src.type} -> cpu)")
        elif src.type == "cpu" and dst.type != "meta":
            self.transfers.append(f"{name} (cpu -> {dst.type})")


_INDEXING = ("aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_")


def _reads_data(func, args, kwargs) -> bool:
    """Whether a call's output (its value or its size) depends on the data of
    its operands, so the host must read them: ``.item()`` and the like, and
    the ops of a data-dependent shape (``nonzero``, a boolean mask's
    indexing, ``repeat_interleave`` without ``output_size``)."""
    name = func._schema.name
    if name in _INDEXING:  # integer indices have a static shape
        return any(t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1]))
    return (torch.Tag.data_dependent_output in func.tags
            or (torch.Tag.dynamic_output_shape in func.tags
                and not _static_size(func, args, kwargs)))


def _static_size(func, args, kwargs) -> bool:
    """Whether a call of an op whose output size may depend on the data
    names that size (``repeat_interleave(..., output_size=n)``): then nothing
    is read back."""
    names = [a.name for a in func._schema.arguments]
    if "output_size" not in names:
        return False
    i = names.index("output_size")
    size = kwargs.get("output_size", args[i] if i < len(args) else None)
    return size is not None


def _fake_errors() -> tuple:
    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
    )

    return DataDependentOutputException, DynamicOutputShapeException


@dataclasses.dataclass
class RoundAudit:
    """One audited call: its findings, the host reads and transfers it
    issued, its collectives (``tally``) and its kernel launches by kernel
    (real launches on the card, fake ones on fake tensors)."""

    findings: list[Finding]
    host_reads: list[str]
    transfers: list[str]
    tally: CollectiveTally
    kernels: dict[str, int]


def _kernel_launches() -> dict[str, int]:
    from repro_torch.kernels import gmf_compress as gk

    out = dict(gk.FAKE_LAUNCHES)
    for name in gk.LAUNCHES:
        out[name] = out.get(name, 0) + gk.LAUNCHES[name]
    return out


def audit_round(fn, args, *, where: str) -> RoundAudit:
    """Call ``fn(*args)`` once under the recorders and audit what it issued;
    see the module docstring. A host read that raises on fake tensors ends
    the call and is reported; any other exception propagates."""
    before = _kernel_launches()
    traffic, tally = HostTraffic(), CollectiveTally()
    with tally, traffic:
        try:
            fn(*args)
        except _fake_errors():
            if not traffic.host_reads:
                raise
    after = _kernel_launches()
    kernels = {k: n - before.get(k, 0) for k, n in after.items() if n - before.get(k, 0)}
    findings = []
    for op in traffic.host_reads:
        findings.append(Finding(
            "JAXPR-CALLBACK", where, 0,
            f"host read `{op}` inside the round fn — the host waits for the device and "
            f"the round cannot be captured as a CUDA graph"))
    for op in traffic.transfers:
        findings.append(Finding(
            "JAXPR-TRANSFER", where, 0,
            f"`{op}` inside the round fn — transfers belong outside it (make the data "
            f"once and pass it as an argument)"))
    for kind, dtype, op in tally.calls:
        if kind in _REDUCE_KINDS and op == "sum" and dtype in _HALF_DTYPES:
            findings.append(Finding(
                "JAXPR-PSUM-DTYPE", where, 0,
                f"`{kind}` SUM of a {dtype} operand — cross-rank sums accumulate in "
                f"float32 (decode the wire payload before the reduce); integer counters "
                f"are exact and fine"))
    return RoundAudit(findings, traffic.host_reads, traffic.transfers, tally, kernels)


def collective_counts(tally: CollectiveTally) -> dict[str, int]:
    """Per-kind collective counts of a tally (the quantity the baseline pins:
    byte sizes shift with shapes, counts only with the pattern)."""
    return dict(sorted(tally.counts.items()))


# -- pinned configs ---------------------------------------------------------

_D_IN, _D_OUT = 12, 4

# name -> FL round configuration; ``devices`` is the world the round runs in
# (a fake one above 1).
AUDITED_CONFIGS: dict[str, dict] = {
    "vmap_dgcwgmf": dict(backend="vmap", scheme="dgcwgmf", clients=4, devices=1),
    "shard_dgcwgmf": dict(backend="shard", scheme="dgcwgmf", clients=8, shards=8, devices=8),
    "shard_none": dict(backend="shard", scheme="none", clients=8, shards=8, devices=8),
    "ring_dgcwgmf": dict(backend="shard", scheme="dgcwgmf", clients=4, shards=4, devices=4,
                         topology="ring", ring_hops=1),
}

_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int64): torch.int64}

DEFAULT_BASELINE = Path(__file__).resolve().with_name("collectives_baseline.json")


def _loss_fn(params, batch):
    """The pinned configs' linear-softmax loss."""
    bx, by = batch
    logp = torch.log_softmax(bx @ params["w"] + params["b"], dim=-1)
    return -torch.mean(torch.gather(logp, -1, by[..., None]))


def tiny_round(spec: dict, *, device="cuda", fake=True):
    """One round fn of a pinned config and its arguments: ``(engine, args)``,
    ``engine.round_fn(*args)`` the round. The engine and state are built as
    ``FLSimulator`` builds them; under ``fake`` every tensor is an empty one
    (the caller is inside a ``FakeTensorMode``), else the data is drawn from
    ``np.random.default_rng(0)`` as the reference draws it. The shard
    backend runs over the default process group."""
    from repro_torch.core import CompressionConfig, init_states, stack_client_states
    from repro_torch.fl import FLConfig
    from repro_torch.fl.engine import make_engine
    from repro_torch.utils.flat import FlatLayout

    clients = spec["clients"]
    rng = np.random.default_rng(0)
    host = {"x": rng.normal(size=(clients, 8, _D_IN)).astype(np.float32),
            "y": rng.integers(0, _D_OUT, size=(clients, 8)),
            "w": (0.1 * rng.normal(size=(_D_IN, _D_OUT))).astype(np.float32),
            "b": np.zeros((_D_OUT,), np.float32)}
    if fake:
        t = {k: torch.empty(v.shape, dtype=_DTYPES[v.dtype], device=device)
             for k, v in host.items()}
    else:
        t = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    params = {"w": t["w"], "b": t["b"]}
    fl = FLConfig(num_clients=clients, rounds=1, clients_per_round=clients, batch_size=8,
                  backend=spec["backend"], shards=spec.get("shards", 0),
                  topology=spec.get("topology", "star"), ring_hops=spec.get("ring_hops", 0))
    ccfg = CompressionConfig(scheme=spec["scheme"], rate=0.25, tau=0.3)
    layout = FlatLayout.of(params)
    engine = make_engine(fl, ccfg, _loss_fn, clients, layout)
    cstate, sstate = init_states(ccfg, params)
    ids = torch.arange(clients, dtype=torch.int64, device=device)
    args = (params, stack_client_states(cstate, clients), sstate, layout.zeros(), ids,
            (t["x"], t["y"]), 0, 0.1, None)
    return engine, args


def audit_two_rounds(engine, args, *, where: str) -> RoundAudit:
    """Round 1 unaudited (it builds the layout's caches), round 2 audited,
    fed round 1's outputs (the broadcast as ``gbar_prev``) at round index 1."""
    params, cstates, sstate, bcast = engine.round_fn(*args)[:4]
    return audit_round(engine.round_fn, (params, cstates, sstate, bcast, *args[4:6], 1,
                                         *args[7:]), where=where)


@contextlib.contextmanager
def fake_world(world: int):
    """A fake world of ``world`` ranks, this process rank 0, torn down on
    exit; nothing for a world of one."""
    if world == 1:
        yield
        return
    with dryrun.fake_world(world):
        yield


@contextlib.contextmanager
def fake_tensors():
    """Fake tensors for a pass: ``FakeTensorMode`` inside the dry run's
    emptied caches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with dryrun.fresh_caches(), FakeTensorMode():
        yield


def check_can_trace(device) -> None:
    """Raise unless this process can make fake tensors on ``device``."""
    if torch.device(device).type != "cuda":
        return
    if not dryrun.can_trace():
        raise RuntimeError(
            "fake CUDA tensors need a build of PyTorch with CUDA or the shim preloaded: run "
            "under repro_torch.launch.dryrun.tracer_env() (python -m repro_torch.analysis "
            "does), or pass device='cpu'")


def audit_pinned(name: str, *, device="cuda", world: int | None = None,
                 fake: bool = True) -> RoundAudit:
    """Round 2 of one pinned config, audited (``world`` ranks instead of the
    config's, where given): on fake tensors in its fake world, or
    (``fake=False``) on real tensors over the caller's default process
    group."""
    spec = dict(AUDITED_CONFIGS[name])
    if world is not None:
        spec.update(devices=world, shards=world)
    if fake:
        check_can_trace(device)
    world_ctx = fake_world(spec["devices"]) if fake else contextlib.nullcontext()
    with world_ctx, (fake_tensors() if fake else contextlib.nullcontext()):
        engine, args = tiny_round(spec, device=device, fake=fake)
        return audit_two_rounds(engine, args, where=f"jaxpr:{name}")


def fake_twin(engine, args):
    """The engine of a star round and its arguments again, on fake tensors of
    the same shapes, dtypes and devices (call it inside ``fake_tensors()``):
    the fake pass of a round a real run makes."""
    from repro_torch.fl.engine import make_engine
    from repro_torch.utils import tree_map
    from repro_torch.utils.flat import FlatLayout

    fake = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                    if isinstance(t, torch.Tensor) else t, list(args))
    layout = FlatLayout.of(fake[0])
    twin = make_engine(engine.fl, engine.comp, engine.loss_fn, engine.sampled_per_round,
                       layout)
    return twin, tuple(fake)


def audit_config(name: str, *, device="cuda") -> tuple[list[Finding], dict]:
    """Audit one pinned config on fake tensors in its fake world: the round-fn
    checks and the collective counts. Returns ``(findings, report)``, the
    report carrying what the baseline pins."""
    audit = audit_pinned(name, device=device)
    report = {"devices": AUDITED_CONFIGS[name]["devices"],
              "counts": collective_counts(audit.tally),
              "num_collectives": sum(audit.tally.counts.values())}
    return audit.findings, report


def audit_all(names=None, *, device="cuda") -> tuple[list[Finding], dict]:
    findings: list[Finding] = []
    reports: dict[str, dict] = {}
    for name in (names if names is not None else AUDITED_CONFIGS):
        f, report = audit_config(name, device=device)
        findings.extend(f)
        reports[name] = report
    return findings, reports


def check_baseline(reports: dict, baseline_path=DEFAULT_BASELINE) -> list[Finding]:
    """Compare fresh collective counts against the committed baseline."""
    baseline_path = Path(baseline_path)
    if not baseline_path.exists():
        return [Finding("JAXPR-BASELINE", str(baseline_path), 0,
                        "baseline file missing — run `python -m repro_torch.analysis "
                        "--jaxpr --write-baseline`")]
    baseline = json.loads(baseline_path.read_text()).get("configs", {})
    findings = []
    for name, report in reports.items():
        pinned = baseline.get(name)
        if pinned is None:
            findings.append(Finding(
                "JAXPR-BASELINE", f"jaxpr:{name}", 0,
                f"config not in {baseline_path} — regenerate the baseline"))
            continue
        if (pinned.get("counts") != report["counts"]
                or pinned.get("num_collectives") != report["num_collectives"]):
            findings.append(Finding(
                "JAXPR-BASELINE", f"jaxpr:{name}", 0,
                f"collective profile changed: pinned {pinned.get('counts')} "
                f"(n={pinned.get('num_collectives')}) vs issued {report['counts']} "
                f"(n={report['num_collectives']}) — if intentional, regenerate "
                f"{baseline_path.name} (--jaxpr --write-baseline) and put "
                f"`analysis-baseline` in the commit message"))
    return findings


def write_baseline(reports: dict, baseline_path=DEFAULT_BASELINE) -> None:
    doc = {"version": 1,
           "note": "collective counts of one round per pinned config (CollectiveTally on "
                   "fake tensors); regenerate with: python -m repro_torch.analysis --jaxpr "
                   "--write-baseline",
           "configs": reports}
    Path(baseline_path).write_text(json.dumps(doc, indent=2, sort_keys=True) + "\n")
