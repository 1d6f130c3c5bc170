"""Per-token determinism audit log: a provenance record per committed token.

"Beyond Reproducibility: Token Probabilities Expose LLM Nondeterminism"
(PAPERS.md) makes the case that determinism must be *observed* at token
granularity, not just asserted end-to-end.  This module is that
observation: every token the engine commits gets exactly one
:class:`TokenProvenance` record saying **why** it is deterministic — which
reduction schedule committed it, which verify window (and which occurrence
slot of the state-pool ring) it landed through, how much of its window
matched, whether it survived a rollback/cascade at its commit point, and
the verifier's top-1/top-2 logit margin at its position.

The margin field is the dataset the ROADMAP's margin-gated sparse
verification item calibrates against: a token committed with margin ``m``
is stable under any reduction reordering whose accumulated error is
``< m/2``, so the gate's threshold comes straight from this log's margin
distribution vs the kernel error bound.

Record semantics per origin:

* ``prefill`` — T0, sampled from the prompt's last logit under the fixed
  verify-grade schedule (deterministic by construction; window = -1).
* ``decode``  — a fast-path token committed *directly* (NONDET /
  BATCH_INVARIANT modes, and non-deterministic requests under LLM42);
  ``schedule`` is the fast-path schedule that produced it.  LLM42
  deterministic requests never commit from decode — their fast-path
  tokens are candidates, which only appear here once a verify pass
  commits them (origin ``verify``).
* ``verify``  — a token committed by a verify splice: the first
  ``n_match`` are accepted candidates, the last is the verifier's own
  commit token.  ``window``/``occurrence`` name the committing window;
  for pipelined windows ``window`` is the per-request submission sequence
  number, for synchronous (pause-style) passes the per-request verify-pass
  ordinal.  ``rollback``/``cascaded`` say what the committing splice did
  to the speculation behind it — the *victims* of that rollback get no
  record at all (they were never committed).

Rollback victims having no records is the invariant the unit tests pin:
the log covers the committed stream exactly — one record per committed
index, token values matching — and nothing else.

Like the tracer, the log is host-side bookkeeping over values the engine
already computed; margins are produced unconditionally inside the jitted
passes (identical device programs audit-on/off) and only *converted to
Python floats* when a real :class:`AuditLog` is attached.  Committed
streams are bitwise identical either way.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class TokenProvenance:
    """Why one committed token is what it is."""

    rid: int  #: request id
    index: int  #: output index in the committed stream (0 = T0)
    token: int  #: the committed token id
    origin: str  #: "prefill" | "decode" | "verify"
    #: reduction schedule of the committing pass.  Call sites pass the
    #: Schedule object itself (the taint pass proves those names resolve
    #: to VERIFY/INVARIANT on commit paths); it is normalized to
    #: ``str(tuple(schedule))`` here.
    schedule: str
    window: int = -1  #: committing verify window id (-1: not a verify commit)
    occurrence: int = -1  #: state-pool ring slot of that window
    n_match: int = -1  #: the committing window's matched-prefix length
    accepted: bool = False  #: True: matched candidate; False: verifier token
    rollback: bool = False  #: the committing splice rejected speculation
    cascaded: int = 0  #: later windows cascade-invalidated by that splice
    shifted: int = 0  #: candidates the window lost to front normalization
    margin: Optional[float] = None  #: top-1 minus top-2 logit margin

    def __post_init__(self) -> None:
        if not isinstance(self.schedule, str):
            object.__setattr__(
                self, "schedule", str(tuple(self.schedule))
            )

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class NullAudit:
    """No-op recorder (auditing off): one flag check per call site."""

    enabled = False

    def record(self, rec: TokenProvenance) -> None:
        pass


class AuditLog(NullAudit):
    enabled = True

    def __init__(self) -> None:
        self.records: List[TokenProvenance] = []

    def record(self, rec: TokenProvenance) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def for_request(self, rid: int) -> List[TokenProvenance]:
        """One request's records, committed-stream order."""
        return sorted(
            (r for r in self.records if r.rid == rid), key=lambda r: r.index
        )

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r.to_json()) + "\n")

    def coverage_errors(self, requests: Iterable[Any]) -> List[str]:
        """Check the log covers each request's committed stream exactly:
        every committed index has exactly one record, every record's token
        matches the stream, and no record points outside it (rollback
        victims were never committed, so they must not appear).  Returns
        human-readable problems; empty = the log is a complete, consistent
        certificate."""
        errs: List[str] = []
        by_rid: Dict[int, List[TokenProvenance]] = {}
        for rec in self.records:
            by_rid.setdefault(rec.rid, []).append(rec)
        known = set()
        for req in requests:
            known.add(req.rid)
            committed: Sequence[int] = req.committed
            recs = by_rid.get(req.rid, [])
            seen: Dict[int, int] = {}
            for rec in recs:
                seen[rec.index] = seen.get(rec.index, 0) + 1
                if rec.index < 0 or rec.index >= len(committed):
                    errs.append(
                        f"rid {req.rid}: record index {rec.index} outside "
                        f"committed stream of length {len(committed)}"
                    )
                elif rec.token != committed[rec.index]:
                    errs.append(
                        f"rid {req.rid} index {rec.index}: record token "
                        f"{rec.token} != committed {committed[rec.index]}"
                    )
            for idx in range(len(committed)):
                n = seen.get(idx, 0)
                if n != 1:
                    errs.append(
                        f"rid {req.rid} index {idx}: {n} provenance "
                        f"records (want exactly 1)"
                    )
        for rid in sorted(set(by_rid) - known):
            errs.append(f"records for unknown rid {rid}")
        return errs
