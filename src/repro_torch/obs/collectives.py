"""A tally of the collectives a rank issues, by the reference's kinds.

``CollectiveTally`` is a ``TorchDispatchMode`` over the ``c10d`` ops (and
the functional ``_c10d_functional`` ones DTensor issues): every
``torch.distributed`` collective reaches the dispatcher as one of them,
whichever module calls it, so one mode counts them all. It works the same
over a real world (gloo, NCCL) and over a fake one
(``torch.testing._internal.distributed.fake_pg``), where a collective moves
nothing but is still issued.

The kinds and the byte convention are those of the reference's
``parse_collective_bytes`` (``repro.analysis.jaxpr_audit``), which reads
them from the partitioned HLO: ``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all`` and ``collective-permute`` (point to
point; a pair counts once, at the receiver), each collective counting its
*result* buffer on this rank (a ring's 2(n−1)/n factor is left to the
reader). ``summary()`` is the same dict: bytes by kind, ``num_collectives``
and ``total_bytes``; ``counts`` holds the number of each kind, and
``calls`` each collective in issue order as ``(kind, operand dtype, reduce
op)`` (the op ``"sum"``, ``"max"``, …, or None for a collective that
reduces nothing), which ``analysis.jaxpr_audit`` reads for a
half-precision SUM. A broadcast
counts as a ``collective-permute`` of the root's buffer (the reference
has no broadcast kind); barriers count nothing.

A dispatch mode reaches the thread that entered it: autograd runs the
backward of CUDA tensors on its own device threads, so the tally turns
autograd's multithreading off while it is entered
(``torch.autograd.set_multithreading_enabled(False)``): the backward then
runs, and its collectives are counted, on the calling thread.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# op name -> (kind, where its result lies: "first" = the first argument, which
# the op writes in place; "out" = the op's returned tensor)
_OPS = {
    "c10d::allreduce_": ("all-reduce", "first"),
    "c10d::allreduce_coalesced_": ("all-reduce", "first"),
    "c10d::reduce_": ("all-reduce", "first"),
    "c10d::allgather_": ("all-gather", "first"),
    "c10d::_allgather_base_": ("all-gather", "first"),
    "c10d::allgather_coalesced_": ("all-gather", "first"),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", "first"),
    "c10d::gather_": ("all-gather", "first"),
    "c10d::reduce_scatter_": ("reduce-scatter", "first"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", "first"),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", "first"),
    "c10d::scatter_": ("reduce-scatter", "first"),
    "c10d::alltoall_": ("all-to-all", "first"),
    "c10d::alltoall_base_": ("all-to-all", "first"),
    "c10d::recv_": ("collective-permute", "first"),
    "c10d::recv_any_source_": ("collective-permute", "first"),
    "c10d::broadcast_": ("collective-permute", "first"),
    "_c10d_functional::all_reduce": ("all-reduce", "out"),
    "_c10d_functional::all_reduce_": ("all-reduce", "first"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional::all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "_c10d_functional::all_to_all_single": ("all-to-all", "out"),
    "_c10d_functional::broadcast": ("collective-permute", "out"),
    "_c10d_functional::broadcast_": ("collective-permute", "first"),
}


def _first_tensor(x):
    """The first tensor in ``x`` (a tensor, or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        return x
    for y in x if isinstance(x, (list, tuple)) else ():
        t = _first_tensor(y)
        if t is not None:
            return t
    return None


def _reduce_op(func, args) -> str | None:
    """The reduce op of a collective's call: ``"sum"``, ``"max"``, …; None
    where the op takes none."""
    names = [a.name for a in func._schema.arguments]
    if "reduce_op" not in names:
        return None
    op = args[names.index("reduce_op")]
    if isinstance(op, str):  # the functional collectives name it
        return op.lower()
    return torch.distributed.ReduceOp.RedOpType(op._get_method("op")()).name.lower()


def _bytes(x) -> int:
    """The bytes of the tensors in ``x`` (a tensor, or nested lists of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    return 0


class CollectiveTally(TorchDispatchMode):
    """``with CollectiveTally() as tally: ...`` counts the collectives the
    block issues on this rank: ``tally.counts`` (kind -> number) and
    ``tally.bytes`` (kind -> result bytes), ``tally.calls`` (each one's
    kind, operand dtype and reduce op); ``summary()`` as the reference's
    ``parse_collective_bytes``."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}
        self.bytes: dict[str, int] = {}
        self.calls: list[tuple[str, str, str | None]] = []
        self._threads = None

    def __enter__(self):
        self._threads = torch.autograd.set_multithreading_enabled(False)
        self._threads.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._threads.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        hit = _OPS.get(func._schema.name)
        if hit is not None:
            kind, where = hit
            result = args[0] if where == "first" else out
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.bytes[kind] = self.bytes.get(kind, 0) + _bytes(result)
            operand = _first_tensor(args[0])
            dtype = str(operand.dtype).removeprefix("torch.") if operand is not None else ""
            self.calls.append((kind, dtype, _reduce_op(func, args)))
        return out

    def summary(self) -> dict:
        """Result bytes by kind, ``num_collectives`` and ``total_bytes``."""
        out: dict = {k: float(v) for k, v in self.bytes.items()}
        out["num_collectives"] = sum(self.counts.values())
        out["total_bytes"] = float(sum(self.bytes.values()))
        return out
