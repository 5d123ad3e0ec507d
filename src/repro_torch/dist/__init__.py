"""The reference's ``repro.dist`` on one device: the train step (dense and
the GMF grad-sync modes at one shard) and the prefill/decode steps.
The sharding half (``sharding``, ``train_state_specs``) needs the mesh:
ROADMAP Queue 1 item 11 part B."""

from repro_torch.dist import step
from repro_torch.dist.step import (
    GRAD_SYNC_MODES,
    TrainState,
    init_train_state,
    make_loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    needs_fsdp,
)

__all__ = [
    "step",
    "GRAD_SYNC_MODES",
    "TrainState",
    "init_train_state",
    "make_loss_fn",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "needs_fsdp",
]
