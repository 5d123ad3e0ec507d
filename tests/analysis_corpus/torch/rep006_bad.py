"""REP006 seeded violations (torch form): mutable defaults shared across calls."""

import dataclasses

import torch


def accumulate(update, residual={}):  # expect: REP006
    residual.update(update)
    return residual


def make_state(shape, momentum=torch.zeros(4)):  # expect: REP006
    return {"m": momentum}


@dataclasses.dataclass
class Config:
    overrides: dict = dataclasses.field(default={})  # expect: REP006
