"""REP003 seeded violations (torch form): float32 casts of counts."""

import numpy as np
import torch


def float_of_nnz(mask):
    nnz = torch.sum(mask != 0, dim=1)
    return nnz.float()  # expect: REP003


def to_float32(info):
    return info.upload_nnz.to(torch.float32)  # expect: REP003


def to_dtype_keyword(union_nnz, dev):
    return union_nnz.to(dev, dtype=torch.float32)  # expect: REP003


def type_float32(counts):
    return counts.type(torch.float32)  # expect: REP003


def tensor_of_param_count(cfg, dev):
    return torch.tensor(cfg.param_count, dtype=torch.float32, device=dev)  # expect: REP003


def as_tensor_of_bytes(upload_bytes):
    return torch.as_tensor(upload_bytes, dtype=torch.float)  # expect: REP003


def numpy_forms(metrics, upload_bytes):
    a = np.asarray(metrics["upload_nnz"], dtype=np.float32)  # expect: REP003
    b = np.float32(upload_bytes)  # expect: REP003
    return a, b
