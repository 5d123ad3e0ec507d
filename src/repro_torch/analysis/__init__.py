"""Static analysis of the port: the reference's ``repro.analysis``, for torch.

Three analyzer families, one Finding type:

- :mod:`repro_torch.analysis.lints` — AST rules (``REPxxx``, the
  reference's ids) over the port's files, in the torch form of each bug
  class (key and seed reuse of the draws, zero-copy aliases of a mutated
  host buffer, float32 counts, host syncs in timed loops, …).
- :mod:`repro_torch.analysis.contracts` — every registered preset and
  stage run through the engine seams on fake tensors
  (``FakeTensorMode``): the state is a fixed point of a round, the
  broadcast float32, the counters integer, the ``[3, N]`` client stack
  kept, round 2 free of host reads.
- :mod:`repro_torch.analysis.jaxpr_audit` — the round fn audited by
  dispatch (host reads, host-to-device copies, half-precision SUM
  collectives) and the per-config collective gate, counted by
  ``obs.collectives.CollectiveTally`` and pinned against the committed
  ``analysis/collectives_baseline.json``.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis --all

Only :class:`~repro_torch.analysis.findings.Finding` is imported eagerly
here; import the families explicitly.
"""

from repro_torch.analysis.findings import Finding, print_findings, to_json

__all__ = ["Finding", "print_findings", "to_json"]
