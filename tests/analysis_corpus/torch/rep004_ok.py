"""REP004 clean twin: transfers happen outside the timed region."""

import time

import torch

from repro_torch.obs import trace


def read_after_span(step_fn, state, batches):
    losses = []
    for batch in batches:
        with trace.span("train/step"):
            state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"])  # a device value; no read
    return state, torch.stack(losses).cpu()


def synchronize_ends_the_clock(step_fn, state, batches):
    device_nnz = []
    t0 = time.perf_counter()
    for batch in batches:
        state, metrics = step_fn(state, batch)
        device_nnz.append(metrics["upload_nnz"])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    host = torch.stack(device_nnz).cpu().numpy()
    return state, host, elapsed


def untimed_loop_may_read(rounds, round_fn, state):
    total = 0
    for t in range(rounds):
        state, nnz = round_fn(state, t)
        total += nnz.item()
    return state, total
