"""Span-based tracing aligned with ``torch.profiler`` and NVTX.

``with span("round/aggregate"):`` opens a named span: spans nest (a
thread-local stack builds slash-joined paths), wall-clock duration lands
in the ``trace.span_ms`` histogram labeled by the full path, and the
span body runs inside ``torch.profiler.record_function`` (and, on a
CUDA build with a card, an NVTX range) so host spans line up with
device activity when a profile is being captured.

Cost model: when telemetry is disabled ``span()`` returns a shared
no-op context manager — no clock read, no annotation, nothing. When
enabled, the cost is two ``perf_counter`` reads, one profiler range, one
NVTX push/pop where there is NVTX and one histogram observe per span;
spans wrap *host-side* sections only (the round, the dispatch, the
flush) — never per-element work.

:func:`annotate_scope` names the round's phases (client gradients,
compression, aggregation, the update) for a ``torch.profiler`` trace
whether or not telemetry is on: a ``record_function`` range, which costs
a few microseconds when no profiler runs and launches nothing. With
telemetry on it also pushes an NVTX range on a card.

NVTX exists only in a CUDA build: a CPU build's
``torch.cuda.nvtx.range_push`` raises. Whether to call it is decided
once, at the first enabled span, and never on a CPU build; NVTX is an
annotation, so no computation changes device either way.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

from repro_torch.obs import metrics as _metrics

_state = threading.local()


class _NullSpan:
    """Reentrant, shared no-op context manager (disabled path)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


@functools.cache
def nvtx_available() -> bool:
    """Does this process push NVTX ranges? (a CUDA build with a card)"""
    return torch.version.cuda is not None and torch.cuda.is_available()


@contextlib.contextmanager
def _ranges(name: str):
    """``name`` as a profiler range and, where there is NVTX, an NVTX range."""
    with torch.profiler.record_function(name):
        if not nvtx_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _stack() -> list[str]:
    st = getattr(_state, "stack", None)
    if st is None:
        st = _state.stack = []
    return st


@contextlib.contextmanager
def _active_span(name: str, rec):
    st = _stack()
    st.append(name)
    path = "/".join(st)
    t0 = time.perf_counter()
    try:
        with _ranges(name):
            yield path
    finally:
        dt_ms = (time.perf_counter() - t0) * 1e3
        st.pop()
        rec.observe("trace.span_ms", dt_ms, span=path)


def span(name: str):
    """Context manager timing one named, nestable host-side section."""
    rec = _metrics.get()
    if not rec.enabled:
        return _NULL_SPAN
    return _active_span(name, rec)


def current_path() -> str:
    """Slash-joined path of the currently open spans ("" outside any)."""
    return "/".join(_stack())


def annotate_scope(name: str):
    """Name a section of the round for profilers: a ``torch.profiler``
    range always, plus an NVTX range when telemetry is enabled on a card.
    Records no metric (the reference's ``jax.named_scope`` counterpart)."""
    if _metrics.get().enabled:
        return _ranges(name)
    return torch.profiler.record_function(name)
