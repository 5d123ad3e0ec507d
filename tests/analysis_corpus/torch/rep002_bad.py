"""REP002 seeded violations (torch form): a zero-copy tensor of a host
buffer mutated later."""

import numpy as np
import torch


def mutate_after_from_numpy(dev):
    tables = np.zeros((4, 8), np.int32)
    dev_tables = torch.from_numpy(tables).to(dev, non_blocking=True)  # expect: REP002
    tables[0] = 7
    return dev_tables


def inplace_method_after_as_tensor():
    buf = np.ones((16,), np.float32)
    t = torch.as_tensor(buf)  # expect: REP002
    buf.fill(0.0)
    return t


def augassign_after_from_numpy():
    counts = np.zeros((4,), np.int64)
    t = torch.from_numpy(counts)  # expect: REP002
    counts += 1
    return t
