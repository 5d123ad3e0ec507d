"""Where the dry run's reckoned peak and the card's measured one part.

llama3.2-1b as ``chip_smoke.py``'s phase 14 trains it (bf16, batch 8 x 256,
gmf_data, fused dgcwgmf at rate 0.1, mesh-less) on the card: step 1, then
step 2 measured three ways, each after ``reset_peak_memory_stats``:

- plain: ``max_memory_allocated`` and the allocator's peak of requested
  bytes (``memory_stats()["requested_bytes.all.peak"]``, before rounding);
- one thread: the same under ``torch.autograd.set_multithreading_enabled(False)``
  (the fake pass runs its backward so);
- metered: under ``launch.dryrun``'s live-storage meter on the real tensors
  (what the fake pass counts, on the card's run), with, after every op, the
  gap between ``torch.cuda.memory_allocated()`` and the meter's live bytes
  (its largest value and the op where it first passed each GiB), and each
  op's own temporaries (the allocator's peak within the op past its live
  bytes at the op's start and end; the ops with the largest);

then the fake-tensor pass of the same step. One JSON line.

    python3 tools/torch_dryrun_calibration.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import CompressionConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMStream, to_tensors  # noqa: E402
from repro_torch.dist import step as dstep  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

GIB = 2**30


class GapMeter(dryrun._Meter):
    """The dry run's meter on real tensors, watching the allocator beside it:
    after every op the gap between the allocator's live bytes and the
    meter's, and within every op the bytes the op held past its start and
    its end (its own temporaries, which no dispatch mode sees: the
    allocator's peak is reset before each op)."""

    def __init__(self, dev):
        super().__init__()
        self.dev = dev
        self.gap = 0
        self.first_past: dict = {}
        self.inner: dict = {}
        self.inner_peak = 0  # the largest live bytes (meter's, at the op's start) + its inner

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        base = torch.cuda.memory_allocated(self.dev)
        live = self.live
        torch.cuda.reset_peak_memory_stats(self.dev)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        top = torch.cuda.max_memory_allocated(self.dev)
        inner = top - max(base, torch.cuda.memory_allocated(self.dev))
        name = str(func)
        self.inner[name] = max(self.inner.get(name, 0), inner)
        self.inner_peak = max(self.inner_peak, live + (top - base))
        gap = torch.cuda.memory_allocated(self.dev) - self.live
        self.gap = max(self.gap, gap)
        for g in range(1, 1 + max(0, gap) // GIB):
            self.first_past.setdefault(g, name)
        return out


def main() -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = configs.get_config("llama3.2-1b")
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=10, grad_sync="gmf_data")
    ccfg = CompressionConfig(scheme="dgcwgmf", rate=0.1, tau=0.3, use_kernels=True)
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    state = dstep.init_train_state(cfg, tcfg, ccfg, params, None)
    del params
    step = dstep.make_train_step(cfg, tcfg, ccfg, None)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=256, batch_size=8, seed=0)
    state, _ = step(state, to_tensors(next(stream), dev))
    out = {"card": torch.cuda.get_device_name(0)}
    for how in ("plain", "one_thread", "metered"):
        batch = to_tensors(next(stream), dev)
        torch.cuda.synchronize()
        args = dryrun.storage_bytes((state, batch))
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        meter = None
        if how == "plain":
            state, _ = step(state, batch)
        elif how == "one_thread":
            with torch.autograd.set_multithreading_enabled(False):
                state, _ = step(state, batch)
        else:
            meter = GapMeter(dev)
            for t in dryrun._tensors((state, batch)):
                meter.track(t)
            with torch.autograd.set_multithreading_enabled(False), meter:
                state, _ = step(state, batch)
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats(dev)
        rec = {"arguments": args, "allocated_before": before,
               "max_allocated": torch.cuda.max_memory_allocated(dev),
               "requested_peak": stats.get("requested_bytes.all.peak")}
        if meter is not None:
            top = sorted(meter.inner.items(), key=lambda kv: -kv[1])[:8]
            rec.update(meter_peak=meter.peak, max_gap=meter.gap,
                       gap_first_past_gib=meter.first_past, op_temporaries_top=top,
                       meter_live_plus_op_peak=meter.inner_peak)
        out[how] = rec
        del batch
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in to_tensors(next(stream), "cpu").items()}
    del state
    t0 = time.perf_counter()
    got = dryrun.trace_train(cfg, tcfg, ccfg, None, meta)
    out["fake"] = {**got["memory"], "trace_s": time.perf_counter() - t0}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
