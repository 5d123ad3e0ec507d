"""The fake-CUDA parts of ``tests/test_torch_analysis.py``, in one process of
their own under the dry run's shim (``dryrun.tracer_env()``): the port's
contract checks on fake CUDA tensors, over the shipped registry and with
seeded broken stages; the round-fn audit of the pinned configs and of
seeded round fns. Writes one JSON file.

  python tests/torch_analysis_fake.py OUT.json
"""

import contextlib
import json
import sys

import torch
import torch.distributed as dist

from repro_torch.analysis import contracts, jaxpr_audit
from repro_torch.core import registry, stages
from repro_torch.core.registry import SchemeSpec, register_preset

# the seeded stages (the test file seeds the same into the reference)
SEEDED = {"compensator": "_bf16_v_test", "downlink": "_f32_nnz_test",
          "wire": "_bf16_wire_test"}


@contextlib.contextmanager
def registry_sandbox():
    """The port's stage and preset registries, restored on exit."""
    saved_stages = {kind: dict(names) for kind, names in stages.REGISTRY.items()}
    saved_presets, saved_docs = dict(registry.PRESETS), dict(registry.PRESET_DOCS)
    try:
        yield
    finally:
        stages.REGISTRY.clear()
        stages.REGISTRY.update(saved_stages)
        registry.PRESETS.clear()
        registry.PRESETS.update(saved_presets)
        registry.PRESET_DOCS.clear()
        registry.PRESET_DOCS.update(saved_docs)
        registry.resolve.cache_clear()


def seed_stages() -> None:
    """Three broken stages and a preset of the first, in the port's registry."""

    @stages.register("compensator", SEEDED["compensator"])
    class _DowncastingEF(stages.Compensator):
        uses_v = True
        description = "test-only: keeps V in bfloat16 (contract violation)"

        def accumulate(self, cfg, ops, u, v, grad, extra):
            v = v + grad
            return v, u, v

        def extract(self, cfg, ops, u, v, value, masks):
            if masks is None:
                g_out, v = v, v * 0.0
            else:
                g_out, v = v * masks, v * (1.0 - masks)
            return g_out, u, v.to(torch.bfloat16)  # the seeded bug

    @stages.register("downlink", SEEDED["downlink"])
    class _Float32Count(stages.Downlink):
        description = "test-only: counts the broadcast's nnz in float32"

        def apply(self, cfg, wire, residual, bcast, nnz, layout):
            return bcast, residual, nnz.float()  # repro-noqa: REP003 (the seeded bug)

    @stages.register("wire", SEEDED["wire"])
    class _HalfBroadcast(stages.WireCodec):
        description = "test-only: leaves the payload, and so the broadcast, in bfloat16"

        def encode(self, cfg, g_out, state, layout, ctx=None):
            return g_out.to(torch.bfloat16), state

    register_preset(SEEDED["compensator"],
                    SchemeSpec(selector="topk", compensator=SEEDED["compensator"]))


def described(findings) -> list:
    return [[f.rule, f.path, f.message] for f in findings]


def seeded_round_fns() -> dict:
    """Three round fns with one fault each, and a clean one, audited."""
    out = {}
    with jaxpr_audit.fake_tensors():
        x = torch.zeros(8, device="cuda")
        fns = {
            "item": lambda x: x * x.sum().item(),
            "to_cuda": lambda x: x + torch.ones(8).to("cuda"),
            "clean": lambda x: (x * 2.0).sum(0),
        }
        for name, fn in fns.items():
            out[name] = described(jaxpr_audit.audit_round(fn, (x,), where=name).findings)
    with jaxpr_audit.fake_world(2), jaxpr_audit.fake_tensors():
        x = torch.zeros(8, device="cuda")

        def bf16_sum(x):
            y = x.to(torch.bfloat16)
            dist.all_reduce(y, op=dist.ReduceOp.SUM)
            return y

        def fine_reduces(x):  # a bf16 MAX and an integer SUM are fine
            y, n = x.to(torch.bfloat16), x.to(torch.int64)
            dist.all_reduce(y, op=dist.ReduceOp.MAX)
            dist.all_reduce(n, op=dist.ReduceOp.SUM)
            return y, n

        for name, fn in (("bf16_sum", bf16_sum), ("fine_reduces", fine_reduces)):
            a = jaxpr_audit.audit_round(fn, (x,), where=name)
            out[name] = described(a.findings)
            out[name + "_calls"] = [list(c) for c in a.tally.calls]
    return out


def main(out_path: str) -> None:
    res = {"shipped": described(contracts.check_all())}
    with registry_sandbox():
        seed_stages()
        res["seeded"] = described(contracts.check_all())
    res["restored"] = SEEDED["compensator"] not in stages.REGISTRY["compensator"]
    findings, reports = jaxpr_audit.audit_all()
    res["audit"] = {"findings": described(findings), "reports": reports,
                    "baseline": described(jaxpr_audit.check_baseline(reports))}
    res["round_fns"] = seeded_round_fns()
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    torch.set_num_threads(1)  # a test process beside the suite's workers (torch_threads.py)
    main(sys.argv[1])
