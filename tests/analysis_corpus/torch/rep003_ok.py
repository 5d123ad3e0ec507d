"""REP003 clean twin: counts stay integer on the device, float64 on the host."""

import numpy as np
import torch


def count_in_int64(mask):
    return torch.sum(mask != 0, dim=1).to(torch.int64)


def host_accounting_in_float64(info):
    return info.upload_nnz.double()


def tensor_of_param_count(cfg, dev):
    return torch.tensor(cfg.param_count, dtype=torch.int64, device=dev)


def numpy_float64(metrics):
    return np.asarray(metrics["upload_nnz"], dtype=np.float64)


def float32_of_non_count_is_fine(loss):
    return loss.to(torch.float32), loss.float()
