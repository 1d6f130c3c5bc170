"""Determinism-contract checker of the PyTorch port.

The port's counterpart of ``repro.analysis``: the same four passes, finding
keys and allowlist discipline, over the port's own code.  LLM-42's contract
(everything that commits a token runs under one fixed-shape reduction
schedule, paper §2.2/§4) is proven from the programs themselves:

* ``invariance``  — record the eager engine's actual step bodies (verify,
  prefill chunk, batch-invariant decode) at several batch compositions, on
  the CPU or the card, canonicalize the recorded programs with the batch
  abstracted (``trace_utils``), and prove the commit kinds identical
  modulo batch and across TP widths, with negative controls;
* ``hazards``     — walk the live nodes of those programs for
  nondeterminism-prone aten ops and kernel geometry (overlapping scatters,
  batch-extent library reductions, library contractions, fast kernels,
  narrow accumulators, TF32, host reads);
* ``taint``       — AST dataflow over ``core/``, ``serving/``,
  ``models/``: no ``# det: commit-path`` function may reach a
  schedule-carrying op with a fast-path schedule;
* ``kernel_lint`` — source rules over ``kernels/csrc/*.cu`` and ``*.cuh``:
  literal reduction partitions, no shape-chosen tiles, f32 accumulators,
  no atomics; ``// det: fastpath`` code is exempt.

Findings are suppressed only through ``allowlist.toml``, each entry with a
justification.  Run ``python -m repro_torch.analysis.check``.  The package
imports ``torch`` and the standard library only.
"""

from repro_torch.analysis.report import Finding, Report  # noqa: F401
