"""The reference's ``repro.dist``: the train step (dense and the GMF
grad-sync modes), the prefill/decode steps and the train-state plumbing,
on one device or over a mesh whose ``model`` axis is 1.

``sharding`` — partition specs (params, batches, caches, pools) and the
               local pieces of a tree laid over a mesh.
``step``     — train/prefill/serve step builders + train-state plumbing.
"""

from repro_torch.dist import sharding, step
from repro_torch.dist.step import (
    GRAD_SYNC_MODES,
    TrainState,
    init_train_state,
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    needs_fsdp,
    train_state_specs,
)

__all__ = [
    "sharding",
    "step",
    "GRAD_SYNC_MODES",
    "TrainState",
    "init_train_state",
    "make_loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "needs_fsdp",
    "train_state_specs",
]
