"""Continuous-batching serving engine over the paged KV pool: the port of
the reference's ``serve/engine.py``.

One engine tick = (admit as many pending requests as there are free
slots) + (one ``make_paged_serve_step`` decode over *all* slots). New
requests join the running batch the moment a slot frees, and completion is
host-side length bookkeeping, so the decode loop reads nothing back from
the device: generated tokens stay there (per-slot views of each step's
tokens) and are copied to the host once per finished request.

Request lifecycle::

    submit ──▶ pending queue ──▶ admit (alloc pages, prefill into slot)
                  ▲                         │
                  │                         ▼
              evict (free pages,   decode slots (one token per tick,
              row → scratch)  ◀──  done when max_new_tokens reached)

Determinism: with the ``float32`` codec the engine's tokens are the
fixed-batch ``make_prefill_step``/``make_serve_step`` path's for the same
prompts, whatever the arrival order: masked scratch positions contribute
exact zeros to every softmax, so sharing the pool is invisible to the math.

The engine runs on the device its params lie on. The per-slot block
tables, positions, active mask and last tokens live there too: a slot's
row is written on admission (its page row and prompt uploaded from pinned
memory without waiting on the stream) and on eviction (fills), and the
positions advance on the device by the active mask after each step (a
slot's entries are set by ``fill_`` with a Python number: assigning one,
``t[i] = n``, copies a host scalar and waits for the stream). The host
keeps mirrors for the bookkeeping only. Copying the live numpy
``tables`` into the step every tick, as the reference does, would
synchronise the stream each tick on a card (a copy from pageable memory
waits for it), and on the CPU ``torch.from_numpy`` would alias the
buffers the host then mutates. The one device-to-host copy is each
finished request's tokens.

Host ranges ``serve.admit``, ``serve.decode`` and ``serve.finish``
(``obs.trace.annotate_scope``) name the three parts of a tick for a
profiler trace.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.dist import sharding as shr
from repro_torch.dist import step as dstep
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace
from repro_torch.serve import cache as kvcache
from repro_torch.utils import tree_leaves


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving-tier knobs (the step shapes are fixed by them).

    A slot's capacity is ``pages_per_slot * page_size`` tokens (prompt +
    generation); ``prompt_pad`` is the fixed prefill shape every prompt is
    right-padded to, and must be a page multiple so prompt K/V lands on
    page boundaries. ``wire`` picks the KV storage codec: the grad-sync
    wire stage's menu.
    """

    max_slots: int = 4
    page_size: int = 16
    pages_per_slot: int = 8
    prompt_pad: int = 32
    max_new_tokens: int = 16
    wire: str = "float32"
    extra_pages: int = 0   # pool head-room beyond max_slots·pages_per_slot

    def __post_init__(self):
        if self.wire not in kvcache.KV_WIRE_DTYPES:
            raise ValueError(
                f"unknown wire {self.wire!r}; choose from {kvcache.KV_WIRE_DTYPES}")
        if self.prompt_pad % self.page_size != 0:
            raise ValueError(
                f"prompt_pad {self.prompt_pad} must be a multiple of "
                f"page_size {self.page_size}")
        if self.prompt_pad > self.slot_capacity:
            raise ValueError(
                f"prompt_pad {self.prompt_pad} exceeds slot capacity "
                f"{self.slot_capacity}")
        for name in ("max_slots", "page_size", "pages_per_slot",
                     "max_new_tokens"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")

    @property
    def slot_capacity(self) -> int:
        return self.pages_per_slot * self.page_size

    @property
    def num_pages(self) -> int:
        # +1: the reserved scratch page 0
        return 1 + self.max_slots * self.pages_per_slot + self.extra_pages


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int32 token ids
    max_new_tokens: int


class Completion(NamedTuple):
    rid: int
    prompt_len: int
    tokens: np.ndarray          # (max_new_tokens,) generated ids, int32
    admit_tick: int
    done_tick: int
    latency_s: float            # admission → last token ready


def _pinned(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host copy of ``array`` to upload to ``device`` without waiting for
    the stream: pinned for a card (the caching host allocator keeps the
    block until the copy has run), a plain copy for the CPU, so the device
    tensor never aliases a buffer the host mutates."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    return host.pin_memory() if device.type == "cuda" else host.clone()


class ServeEngine:
    """Host-side scheduler over the paged prefill/decode steps, on the
    device of ``params``. Over a ``mesh`` the pool is laid out by
    ``dist.sharding.pool_specs`` (this rank's piece: its kv heads, and the
    int8 codec's scales with them, where they divide the model axis; else
    the whole pool) and the steps carry the mesh: ``params`` are the rank's
    pieces (``sharding.local_tree`` of ``param_specs``), the attention runs
    on the rank's heads, the logits come back whole, and an MoE config's
    ticks and admissions run the expert-parallel MoE. The tables,
    positions and tokens are the same on every rank: every rank submits the
    same requests, and a tick reads nothing more from the device."""

    def __init__(self, cfg, params, scfg: ServeConfig, mesh=None):
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.codec = kvcache.make_kv_codec(scfg.wire, cfg)
        self._prefill = dstep.make_paged_prefill_step(cfg, self.codec, mesh,
                                                      prompt_pad=scfg.prompt_pad)
        self._step = dstep.make_paged_serve_step(cfg, self.codec, mesh)
        self.pool = kvcache.init_pool(cfg, self.codec, scfg.num_pages, scfg.page_size,
                                      device=self.device)
        if mesh is not None:
            self.pool = shr.local_tree(self.pool, shr.named_shardings(
                mesh, shr.pool_specs(self.pool, mesh)))
        self.alloc = kvcache.BlockAllocator(scfg.num_pages)
        self._next_rid = 0
        self._pending: list[tuple[int, Request]] = []  # (arrival_tick, req)

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int | None = None,
               arrival_tick: int = 0) -> int:
        """Queue one request; it becomes admissible at ``arrival_tick``.
        Returns the request id."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        gen = self.scfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if len(prompt) < 1 or len(prompt) > self.scfg.prompt_pad:
            raise ValueError(
                f"prompt length {len(prompt)} not in [1, {self.scfg.prompt_pad}]")
        if len(prompt) + gen > self.scfg.slot_capacity:
            raise ValueError(
                f"prompt {len(prompt)} + gen {gen} exceeds slot capacity "
                f"{self.scfg.slot_capacity}")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append((arrival_tick, Request(rid, prompt, gen)))
        self._pending.sort(key=lambda t: (t[0], t[1].rid))
        return rid

    # -- the loop -----------------------------------------------------------

    def run(self, on_token: Callable[[int, int], None] | None = None
            ) -> tuple[list[Completion], dict]:
        """Drain the queue. Returns (completions sorted by rid, metrics).

        ``on_token(rid, token)`` streams tokens as they are produced; each
        call reads a token back from the device, so pass it for interactive
        use and leave it None when benchmarking.
        """
        scfg, dev = self.scfg, self.device
        slots: list[dict[str, Any] | None] = [None] * scfg.max_slots
        tables = np.zeros((scfg.max_slots, scfg.pages_per_slot), np.int64)  # host mirror
        tables_dev = torch.zeros(tables.shape, dtype=torch.int64, device=dev)
        lengths = torch.zeros((scfg.max_slots,), dtype=torch.int64, device=dev)
        active = torch.zeros((scfg.max_slots,), dtype=torch.int64, device=dev)
        last_tok = torch.zeros((scfg.max_slots,), dtype=torch.int64, device=dev)
        completions: list[Completion] = []
        tick = ticks = 0
        t_start = time.perf_counter()
        # Peaks live in gauge high-water marks (obs/metrics.py). The local
        # registry is always on, so the metrics dict is complete with
        # telemetry disabled; the process recorder also gets the events and
        # series when --obs configured one.
        reg = obs_metrics.Registry()
        g_active = reg.gauge("serve.active_slots")
        g_pages = reg.gauge("serve.pages_in_use")
        h_wait = reg.histogram("serve.admit_wait_ticks")
        rec = obs_metrics.get()

        def finish(i: int, st: dict) -> None:
            with trace.annotate_scope("serve.finish"):
                toks = torch.stack(st["gen"]).cpu().numpy().astype(np.int32)
            latency = time.perf_counter() - st["admit_time"]
            completions.append(Completion(
                rid=st["req"].rid, prompt_len=len(st["req"].prompt),
                tokens=toks, admit_tick=st["admit_tick"],
                done_tick=tick, latency_s=latency))
            rec.event("serve_request", rid=st["req"].rid,
                      wait_ticks=st["wait_ticks"], latency_s=latency,
                      tokens=len(st["gen"]))
            self.alloc.free([int(p) for p in tables[i] if p != kvcache.SCRATCH_PAGE])
            tables[i] = kvcache.SCRATCH_PAGE
            tables_dev[i].fill_(kvcache.SCRATCH_PAGE)
            lengths[i].fill_(0)
            active[i].fill_(0)
            slots[i] = None

        while self._pending or any(s is not None for s in slots):
            # Admit while a slot and an arrived request are both free.
            for i in range(scfg.max_slots):
                if slots[i] is not None or not self._pending:
                    continue
                if self._pending[0][0] > tick:
                    break
                arrival, req = self._pending.pop(0)
                wait = tick - arrival
                h_wait.observe(wait)
                rec.observe("serve.admit_wait_ticks", wait)
                need = -(-(len(req.prompt) + req.max_new_tokens) // scfg.page_size)
                need = max(need, scfg.prompt_pad // scfg.page_size)
                tables[i, :need] = self.alloc.alloc(need)
                toks = np.zeros((1, scfg.prompt_pad), np.int64)
                toks[0, : len(req.prompt)] = req.prompt
                with trace.annotate_scope("serve.admit"):
                    tables_dev[i].copy_(_pinned(tables[i], dev), non_blocking=True)
                    t0, _, self.pool = self._prefill(
                        self.params, _pinned(toks, dev).to(dev, non_blocking=True), self.pool,
                        tables_dev[i], len(req.prompt))
                    lengths[i].fill_(len(req.prompt))
                    active[i].fill_(1)
                    last_tok[i].copy_(t0[0])
                slots[i] = {"req": req, "gen": [t0[0]],
                            "admit_tick": tick, "admit_time": time.perf_counter(),
                            "wait_ticks": wait}
                if on_token is not None:
                    on_token(req.rid, int(t0[0]))  # repro-noqa: REP004 (streaming: on_token takes each token as it comes)
                if len(slots[i]["gen"]) >= req.max_new_tokens:
                    finish(i, slots[i])

            g_active.set(sum(s is not None for s in slots))
            g_pages.set(self.alloc.num_live)
            if not any(s is not None for s in slots):
                tick += 1  # idle: wait for the next arrival
                continue

            # One decode step over every slot (inactive ones write masked
            # scratch); nothing is read back from the device in here.
            with trace.annotate_scope("serve.decode"):
                next_tok, _, self.pool = self._step(self.params, self.pool, tables_dev,
                                                    lengths, last_tok)
                lengths += active
            # An admission writes its slot's row of last_tok: the row of a
            # finished request, whose tokens are on the host by then.
            last_tok = next_tok
            ticks += 1
            for i, st in enumerate(slots):
                if st is None:
                    continue
                st["gen"].append(next_tok[i])
                if on_token is not None:
                    on_token(st["req"].rid, int(next_tok[i]))  # repro-noqa: REP004 (streaming: on_token takes each token as it comes)
                if len(st["gen"]) >= st["req"].max_new_tokens:
                    finish(i, st)
            tick += 1

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t_start
        completions.sort(key=lambda c: c.rid)
        total_new = int(sum(len(c.tokens) for c in completions))
        lat = sorted(c.latency_s for c in completions) or [0.0]
        pool_pages = scfg.num_pages - 1  # page 0 is reserved scratch
        peak_pages = int(g_pages.high_water())
        metrics = {
            "requests": len(completions),
            "decode_ticks": ticks,
            "generated_tokens": total_new,
            "wall_s": wall,
            "tokens_per_s": total_new / wall if wall > 0 else 0.0,
            "latency_p50_s": lat[len(lat) // 2],
            "latency_p99_s": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
            "admit_wait_ticks_mean": h_wait.summary()["mean"],
            "admit_wait_ticks_p99": h_wait.summary()["p99"],
            "peak_active_slots": int(g_active.high_water()),
            "peak_pages": peak_pages,
            "pool_pages": pool_pages,
            "page_pool_occupancy": peak_pages / pool_pages,
            "pool_bytes": kvcache.pool_bytes(self.pool),
        }
        rec.gauge_set("serve.tokens_per_s", metrics["tokens_per_s"])
        rec.gauge_set("serve.peak_active_slots", metrics["peak_active_slots"])
        rec.gauge_set("serve.peak_pages", peak_pages)
        rec.gauge_set("serve.page_pool_occupancy",
                      metrics["page_pool_occupancy"])
        return completions, metrics
