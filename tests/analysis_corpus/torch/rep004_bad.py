"""REP004 seeded violations (torch form): host syncs inside timed loops."""

import time

import numpy as np
import torch

from repro_torch.obs import trace


def item_under_span(rounds, round_fn, state):
    with trace.span("rounds"):
        for t in range(rounds):
            state, nnz = round_fn(state, t)
            total = nnz.item()  # expect: REP004
    return state, total


def float_in_annotated_step(step_fn, state, batches):
    for batch in batches:
        with trace.annotate_scope("train/step"):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # expect: REP004
    return state, loss


def cpu_under_record_function(step_fn, state, batches):
    with torch.profiler.record_function("steps"):
        for batch in batches:
            state, nnz = step_fn(state, batch)
            host = nnz.cpu()  # expect: REP004
    return state, host


def tolist_under_nvtx(step_fn, state, batches):
    out = []
    for batch in batches:
        with torch.cuda.nvtx.range("step"):
            state, tokens = step_fn(state, batch)
            out += tokens.tolist()  # expect: REP004
    return state, out


def numpy_and_int_in_clock_region(step_fn, state, batches):
    t0 = time.perf_counter()
    for batch in batches:
        state, metrics = step_fn(state, batch)
        host = metrics["upload_nnz"].numpy()  # expect: REP004
        down = int(metrics["download_nnz"])  # expect: REP004
        arr = np.asarray(metrics["union_nnz"])  # expect: REP004
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return state, host, down, arr, elapsed
