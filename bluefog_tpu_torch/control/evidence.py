"""Evidence: what each rank observed, disseminated coordinator-free.

Counterpart of ``bluefog_tpu/control/evidence.py``.  Each rank's
:class:`Evidence` record carries its local view of the fleet: per-peer lag
(wire: the :class:`~bluefog_tpu_torch.runtime.window_server.DepositStream`
ack EWMA, kept fresh between deposits by heartbeats; thread mode: seconds
since the peer's last fresh deposit), per-peer health states, per-peer
reconnect deltas (lossy-link evidence) and two scalar mixing signals.  No
rank sees everything, so records are disseminated and every controller
decides over the union:

- **process mode**: one ``ctlev.<rank>`` file a rank in the shared
  barrier directory, written atomically (tmp + rename, so a reader never
  parses a torn record); newest round wins;
- **thread mode**: :class:`EvidenceBoard`, the in-process twin.

Records are canonically JSON-encoded (sorted keys, NaN spelled null),
byte for byte as the JAX package writes them, so either package reads the
other's records.
"""

from __future__ import annotations

import dataclasses
import json
import os

import threading
from typing import Dict, List, Mapping, Optional, Tuple

__all__ = ["Evidence", "EvidenceBoard", "canonicalize", "write_evidence",
           "read_evidence", "clear_evidence"]

_PREFIX = "ctlev"


def _canon_map(m: Optional[Mapping[int, float]], cast) -> Dict[int, float]:
    return {int(k): cast(v) for k, v in (m or {}).items()}


def _canon_phases(m) -> Dict[int, Dict[str, float]]:
    """Canonical per-peer phase map: int peer keys, str phase keys,
    float seconds; non-finite values dropped (canonical JSON has no
    NaN spelling for nested maps)."""
    import math

    out: Dict[int, Dict[str, float]] = {}
    for k, phases in (m or {}).items():
        inner = {str(p): float(v) for p, v in (phases or {}).items()
                 if math.isfinite(float(v))}
        if inner:
            out[int(k)] = inner
    return out


@dataclasses.dataclass(frozen=True)
class Evidence:
    """One rank's round-stamped local observations.

    ``lag_s`` maps peer -> seconds of observed lag (transport-specific,
    see module docstring); ``states`` maps peer -> health-state int
    (:mod:`bluefog_tpu_torch.runtime.resilience` values); ``reconnects`` maps
    peer -> reconnect cycles observed against that peer SINCE THE LAST
    evidence publish (a delta, not a lifetime count — so the signal
    clears when the link heals and hysteresis can release the peer).
    ``mixing_excess`` is measured-minus-predicted contraction (NaN when
    unknown); ``consensus_growth`` is local disagreement now over one
    evidence window ago (NaN until two windows exist).

    ``phase_s`` (optional — empty when tracing is off or the peer's
    connection never negotiated the trace feature) maps peer -> a phase
    decomposition of the observed lag, seconds per phase: ``"net"``
    (wire + server frontend residue), ``"queue"`` (owner apply-queue
    wait), ``"apply"`` (owner apply).  It is what lets
    :func:`~bluefog_tpu_torch.control.controller.decide_plan` tell a slow
    LINK (net-dominated — codec/cadence territory) from a slow HOST
    (queue/apply-dominated — ring-spine penalty territory).  Records
    without it parse and decide exactly as before."""

    rank: int
    round: int
    lag_s: Mapping[int, float] = dataclasses.field(default_factory=dict)
    states: Mapping[int, int] = dataclasses.field(default_factory=dict)
    reconnects: Mapping[int, int] = dataclasses.field(default_factory=dict)
    mixing_excess: float = float("nan")
    consensus_growth: float = float("nan")
    phase_s: Mapping[int, Mapping[str, float]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "lag_s", _canon_map(self.lag_s, float))
        object.__setattr__(self, "states", _canon_map(self.states, int))
        object.__setattr__(self, "reconnects",
                           _canon_map(self.reconnects, int))
        object.__setattr__(self, "phase_s", _canon_phases(self.phase_s))

    def to_json(self) -> str:
        """Canonical encoding (sorted keys; NaN spelled explicitly) —
        what lands in a ``ctlev.<rank>`` record."""
        def num(x):
            return None if x != x else float(x)  # NaN -> null

        return json.dumps(
            {"rank": int(self.rank), "round": int(self.round),
             "lag_s": {str(k): float(v)
                       for k, v in sorted(self.lag_s.items())},
             "states": {str(k): int(v)
                        for k, v in sorted(self.states.items())},
             "reconnects": {str(k): int(v)
                            for k, v in sorted(self.reconnects.items())},
             "mixing_excess": num(self.mixing_excess),
             "consensus_growth": num(self.consensus_growth),
             # phase maps hold only finite floats (canonicalized), so
             # sorted-key dumping keeps the encoding byte-deterministic
             "phase_s": {str(k): {p: float(v)
                                  for p, v in sorted(m.items())}
                         for k, m in sorted(self.phase_s.items())}},
            sort_keys=True, separators=(",", ":"))

    @staticmethod
    def from_json(text: str) -> "Evidence":
        d = json.loads(text)

        def num(x):
            return float("nan") if x is None else float(x)

        return Evidence(
            rank=int(d["rank"]), round=int(d["round"]),
            lag_s={int(k): float(v) for k, v in d["lag_s"].items()},
            states={int(k): int(v) for k, v in d["states"].items()},
            reconnects={int(k): int(v)
                        for k, v in d["reconnects"].items()},
            mixing_excess=num(d.get("mixing_excess")),
            consensus_growth=num(d.get("consensus_growth")),
            # absent in pre-tracing records: they parse (and decide)
            # exactly as before
            phase_s={int(k): dict(m)
                     for k, m in d.get("phase_s", {}).items()})


def canonicalize(evidences) -> Tuple[Evidence, ...]:
    """Deterministic dedup + order: newest round per rank, sorted by
    rank.  Two ranks holding the same record MULTISET in any order
    produce the same tuple — the input normalization that makes the
    decision function order-independent."""
    best: Dict[int, Evidence] = {}
    for ev in evidences:
        cur = best.get(ev.rank)
        if cur is None or ev.round > cur.round:
            best[ev.rank] = ev
    return tuple(best[r] for r in sorted(best))


# --------------------------------------------------------------- MP records
def write_evidence(dirpath: str, ev: Evidence) -> None:
    """Atomically publish rank ``ev.rank``'s record (tmp + rename — a
    concurrent reader sees the old record or the new one, never a torn
    mix; the membership-record discipline)."""
    path = os.path.join(dirpath, f"{_PREFIX}.{int(ev.rank)}")
    with open(path + ".tmp", "w") as f:
        f.write(ev.to_json())
    os.replace(path + ".tmp", path)


def read_evidence(dirpath: str, n_ranks: int) -> List[Evidence]:
    """Every parseable evidence record in the barrier directory.  A
    missing or malformed record is skipped (a rank that has not
    published yet, or a writer caught mid-crash) — decisions are over
    whatever evidence exists, exactly like tombstone scans."""
    out: List[Evidence] = []
    for r in range(n_ranks):
        try:
            with open(os.path.join(dirpath, f"{_PREFIX}.{r}")) as f:
                out.append(Evidence.from_json(f.read()))
        except (OSError, ValueError, KeyError):
            continue
    return out


def clear_evidence(dirpath: str, rank: int) -> None:
    try:
        os.unlink(os.path.join(dirpath, f"{_PREFIX}.{int(rank)}"))
    except OSError:
        pass


# ------------------------------------------------------------- thread board
class EvidenceBoard:
    """In-process evidence table for the rank-THREAD runners: the same
    publish/collect contract as the barrier-dir records, minus the
    filesystem.  Thread-safe; newest round per rank wins."""

    def __init__(self):
        self._mu = threading.Lock()
        self._table: Dict[int, Evidence] = {}

    def publish(self, ev: Evidence) -> None:
        with self._mu:
            cur = self._table.get(ev.rank)
            if cur is None or ev.round >= cur.round:
                self._table[ev.rank] = ev

    def snapshot(self) -> Tuple[Evidence, ...]:
        with self._mu:
            return canonicalize(self._table.values())
