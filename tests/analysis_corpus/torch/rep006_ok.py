"""REP006 clean twin: None defaults constructed inside, or factories."""

import dataclasses

import torch


def accumulate(update, residual=None):
    residual = {} if residual is None else residual
    residual.update(update)
    return residual


def make_state(shape, momentum=None):
    if momentum is None:
        momentum = torch.zeros(shape)
    return {"m": momentum}


@dataclasses.dataclass
class Config:
    overrides: dict = dataclasses.field(default_factory=dict)
    scale: float = 1.0
