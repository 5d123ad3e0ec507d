"""REP002 clean twin: snapshot before the alias, or never mutate after."""

import numpy as np
import torch


def snapshot_before_from_numpy(dev):
    tables = np.zeros((4, 8), np.int32)
    dev_tables = torch.from_numpy(tables.copy()).to(dev, non_blocking=True)
    tables[0] = 7
    return dev_tables


def mutation_before_is_fine():
    buf = np.ones((16,), np.float32)
    buf.fill(0.0)
    return torch.as_tensor(buf)


def no_mutation_at_all():
    counts = np.zeros((4,), np.int64)
    return torch.from_numpy(counts), counts.sum()
