"""Cross-rank merge & hang diagnosis over per-rank blackbox dumps.

Counterpart of ``bluefog_tpu/blackbox/merge.py`` (the ``bfblackbox-tpu``
console script), reading the same files, so it diagnoses either
package's dumps.  ``python -m bluefog_tpu_torch.blackbox <incident-dir>``
reads every ``blackbox-rank*.jsonl`` under the incident directory
(including the supervisor's ``restart-<n>/`` subdirectories), aligns the
per-rank recorders by **(step, collective-id)** and reports:

- the rounds some rank *entered* (``collective_begin``) but never
  *exited* (``collective_end``) — the round the job is wedged in;
- the **suspect rank**: a rank every survivor is waiting on — either it
  wrote no dump at all (SIGSTOPped / OOM-killed / kernel-wedged processes
  cannot dump) or its recorder stops at an earlier round than everyone
  else's;
- the suspect **neighbor edges**, when begin events carry a ``peers``
  list (stuck rank -> suspect peer);
- optionally a merged chrome trace (one pid per rank) for Perfetto.

Alignment key: an event's explicit ``step`` field when present;
otherwise the per-rank occurrence index of its collective id (SPMD
programs make their calls in identical order on every rank, so the k-th
round of a given ``cid`` is the same round on every rank).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["RankDump", "load_incident", "align_rounds", "diagnose",
           "chrome_trace", "main"]


@dataclass
class RankDump:
    """One parsed ``blackbox-rank<k>.jsonl``."""

    rank: int
    path: str
    header: dict = field(default_factory=dict)
    events: List[dict] = field(default_factory=list)
    open_spans: List[dict] = field(default_factory=list)
    stacks: List[dict] = field(default_factory=list)
    metrics: Optional[dict] = None
    complete: bool = False  # saw the {"end": true} marker
    dropped: int = 0        # ring evictions reported by the end marker
    torn: int = 0           # unparseable (torn) lines skipped in the file


def _parse_file(path: str) -> Optional[RankDump]:
    dump: Optional[RankDump] = None
    torn = 0
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    # torn line of a crashed/raced writer: tolerated,
                    # but COUNTED — a skipped line may have been a
                    # begin, and its orphaned end then needs the
                    # truncation caveat, not silence
                    torn += 1
                    continue
                if rec.get("header"):
                    dump = RankDump(rank=int(rec.get("rank", 0)), path=path,
                                    header=rec)
                elif dump is None:
                    continue
                elif "event" in rec:
                    dump.events.append(rec["event"])
                elif "open_spans" in rec:
                    dump.open_spans.extend(rec["open_spans"])
                elif "stacks" in rec:
                    dump.stacks = rec["stacks"]
                elif "metrics" in rec:
                    dump.metrics = rec["metrics"]
                elif rec.get("end"):
                    dump.complete = True
                    dump.dropped = int(rec.get("dropped", 0) or 0)
    except OSError:
        return None
    if dump is not None:
        dump.torn = torn
    return dump


def load_supervisor_restarts(directory: str) -> List[dict]:
    """The supervisor's durable restart markers (``supervisor.jsonl``
    written by ``run_supervised(incident_dir=...)``), oldest first."""
    out: List[dict] = []
    try:
        with open(os.path.join(directory, "supervisor.jsonl")) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def load_incident(directory: str) -> Dict[int, RankDump]:
    """Parse every per-rank dump under ``directory`` (recursive, so the
    supervisor's ``restart-<n>/`` layers are included).  When one rank
    appears more than once (restart layers), the NEWEST file wins — the
    incident being diagnosed is the most recent failure."""
    paths = sorted(
        glob.glob(os.path.join(directory, "**", "blackbox-rank*.jsonl"),
                  recursive=True),
        key=lambda p: os.path.getmtime(p))
    dumps: Dict[int, RankDump] = {}
    for p in paths:
        d = _parse_file(p)
        if d is not None:
            dumps[d.rank] = d  # later (newer) files overwrite
    return dumps


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------


def _round_key(ev: dict, occurrence: int) -> Tuple:
    cid = ev.get("cid") or ev.get("op") or ev.get("window") or "?"
    step = ev.get("step")
    if step is None:
        step = occurrence
    return (step, str(cid))


def align_rounds(dumps: Dict[int, RankDump]) -> Dict[Tuple, dict]:
    """``{(step, cid): {"entered": {rank: event}, "exited": {rank: event}}}``
    over every ``collective_begin``/``collective_end`` in every dump.

    Events carrying an explicit ``step`` align absolutely.  Stepless
    events align by per-rank occurrence index of their cid — and an end
    whose begin fell off the ring (the retained suffix starts mid-round)
    is an ORPHAN: counting it would shift every later pairing by one and
    report a healthy rank's rounds as entered-never-exited, so orphans
    are skipped for occurrence numbering."""
    rounds: Dict[Tuple, dict] = {}
    for rank, d in dumps.items():
        seen_begin: Dict[str, int] = {}
        seen_end: Dict[str, int] = {}
        for ev in d.events:
            kind = ev.get("kind", "")
            if kind == "collective_begin":
                cid = str(ev.get("cid") or ev.get("op") or "?")
                occ = seen_begin.get(cid, 0)
                seen_begin[cid] = occ + 1
                key = _round_key(ev, occ)
                rounds.setdefault(key, {"entered": {}, "exited": {}})
                rounds[key]["entered"][rank] = ev
            elif kind == "collective_end":
                cid = str(ev.get("cid") or ev.get("op") or "?")
                occ = seen_end.get(cid, 0)
                if (ev.get("step") is None
                        and occ >= seen_begin.get(cid, 0)):
                    continue  # orphan: its begin predates the ring window
                seen_end[cid] = occ + 1
                key = _round_key(ev, occ)
                rounds.setdefault(key, {"entered": {}, "exited": {}})
                rounds[key]["exited"][rank] = ev
    return rounds


def diagnose(dumps: Dict[int, RankDump],
             expect_ranks: Optional[int] = None) -> dict:
    """Cross-rank hang diagnosis; returns a JSON-serializable report."""
    present = sorted(dumps)
    world = expect_ranks
    if world is None:
        world = max(
            [d.header.get("world", 0) for d in dumps.values()]
            + [(max(present) + 1) if present else 0])
    missing = [r for r in range(world) if r not in dumps]

    def _order(k):
        # numeric steps sort numerically (step 2 before step 10), anything
        # else after, lexicographically — callers may record their own
        # events with non-numeric steps, and a mixed comparison must
        # never TypeError the whole diagnosis
        s = k[0]
        return ((0, float(s), "") if isinstance(s, (int, float))
                else (1, 0.0, str(s)), k[1])

    rounds = align_rounds(dumps)
    last_completed: Dict[int, Optional[Tuple]] = {r: None for r in present}
    for key, rd in rounds.items():
        for r in rd["exited"]:
            if (last_completed.get(r) is None
                    or _order(key) > _order(last_completed[r])):
                last_completed[r] = key

    stuck = []
    for key in sorted(rounds, key=_order):
        rd = rounds[key]
        stuck_ranks = sorted(set(rd["entered"]) - set(rd["exited"]))
        if stuck_ranks:
            never_entered = sorted(set(present) - set(rd["entered"]))
            peers = sorted({int(p) for r in stuck_ranks
                            for p in rd["entered"][r].get("peers", [])})
            stuck.append({
                "step": key[0], "cid": key[1],
                "stuck_ranks": stuck_ranks,
                "completed_ranks": sorted(rd["exited"]),
                "never_entered": never_entered,
                "peers_of_stuck": peers,
            })

    # Suspect selection: a rank that cannot speak for itself (no dump) is
    # the prime suspect; otherwise the present rank whose recorder stops
    # at the earliest round while others progressed.
    suspects: List[int] = list(missing)
    reason = None
    if missing:
        reason = ("no blackbox dump written — the process was stopped, "
                  "killed, or wedged below Python before it could dump")
    elif stuck:
        first = stuck[0]
        behind = first["never_entered"]
        if behind:
            suspects = behind
            reason = ("entered earlier rounds but never reached the stuck "
                      "round — stalled before it")
        elif first["completed_ranks"]:
            # peers finished the round; whoever entered and never exited
            # is the one holding everyone else's NEXT round hostage
            suspects = first["stuck_ranks"]
            reason = ("entered a round its peers completed but never "
                      "exited it")
        else:
            # everyone entered and nobody exited: a collective-level wedge
            suspects = first["stuck_ranks"]
            reason = "all participants entered the round and none exited"

    edges = []
    for s in stuck:
        for r in s["stuck_ranks"]:
            for p in s["peers_of_stuck"]:
                if p in suspects and p != r:
                    edges.append([r, p])

    # orphaned stepless ends have two distinct causes, and a file can
    # show BOTH: ring eviction (the end marker's dropped count) and
    # file truncation (torn lines / a missing end marker).  Carry every
    # applicable reason — "evicted" alone sends the operator chasing
    # ring capacity when the file was also cut mid-write
    caveats = []
    for r, d in sorted(dumps.items()):
        reasons = []
        if d.dropped:
            reasons.append(f"evicted {d.dropped} event(s) from its ring")
        if d.torn or not d.complete:
            parts = [p for p in (
                f"{d.torn} torn line(s) skipped" if d.torn else "",
                "no end marker" if not d.complete else "") if p]
            reasons.append("dump truncated (" + ", ".join(parts) + ")")
        if reasons:
            caveats.append(
                f"rank {r} " + " AND ".join(reasons) + ": "
                "occurrence-aligned (stepless) rounds may be offset "
                "across ranks — trust step-carrying events first")

    return {
        "world": world,
        "present_ranks": present,
        "missing_ranks": missing,
        "last_completed": {str(r): (list(k) if k else None)
                           for r, k in last_completed.items()},
        "stuck_rounds": stuck,
        "suspect_ranks": suspects,
        "suspect_reason": reason,
        "suspect_edges": sorted(set(map(tuple, edges))),
        "reasons": {
            str(r): ([p.get("reason")
                      for p in d.header.get("previous_dumps", [])]
                     + [d.header.get("reason")]
                     if d.header.get("previous_dumps")
                     else d.header.get("reason"))
            for r, d in dumps.items()},
        "caveats": caveats,
    }


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------


def chrome_trace(dumps: Dict[int, RankDump]) -> List[dict]:
    """Merged trace events, one pid per rank: collective begin/end pairs
    as chrome *async* events (``ph: "b"/"e"``, id = ``step/cid`` — same
    no-mis-nest guarantee as the timeline writer), everything else as
    instants."""
    if not dumps:
        return []
    t0 = min(ev.get("t", 0.0) for d in dumps.values()
             for ev in d.events) if any(d.events for d in dumps.values()) \
        else 0.0
    out: List[dict] = []
    for rank, d in dumps.items():
        out.append({"name": "process_name", "ph": "M", "pid": rank,
                    "args": {"name": f"rank {rank}"}})
        occ: Dict[Tuple[str, str], int] = {}
        for ev in d.events:
            kind = ev.get("kind", "event")
            ts = (ev.get("t", t0) - t0) * 1e6
            if kind in ("collective_begin", "collective_end"):
                phase = "b" if kind.endswith("begin") else "e"
                cid = str(ev.get("cid") or ev.get("op") or "?")
                k = (cid, phase)
                n = occ.get(k, 0)
                occ[k] = n + 1
                step = ev.get("step", n)
                out.append({
                    "name": cid, "cat": "blackbox", "ph": phase,
                    "ts": ts, "pid": rank, "tid": int(ev.get("rank", 0)),
                    # rank in the id: legacy async events pair on
                    # (cat, id) process-globally, so the same round id on
                    # two pids would cross-pair rank 0's begin with rank
                    # 1's end
                    "id": f"{rank}/{step}/{cid}",
                    "args": {k2: v for k2, v in ev.items()
                             if k2 not in ("t", "seq")},
                })
            else:
                out.append({
                    "name": kind, "cat": "blackbox", "ph": "i", "s": "t",
                    "ts": ts, "pid": rank, "tid": int(ev.get("rank", 0)),
                    "args": {k2: v for k2, v in ev.items()
                             if k2 not in ("t", "seq")},
                })
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _format_report(report: dict, directory: str) -> str:
    lines = [
        f"bfblackbox: {len(report['present_ranks'])} rank dump(s) under "
        f"{directory} (world {report['world']})",
    ]
    if report["missing_ranks"]:
        lines.append(f"missing dumps from ranks {report['missing_ranks']}")
    lc = ", ".join(
        f"{r}:{tuple(k) if k else '-'}"
        for r, k in sorted(report["last_completed"].items(),
                           key=lambda kv: int(kv[0])))
    if lc:
        lines.append(f"last completed round per rank: {lc}")
    for s in report["stuck_rounds"]:
        lines.append(
            f"HANG: round (step={s['step']}, collective={s['cid']}) "
            f"entered but never exited by ranks {s['stuck_ranks']}"
            + (f"; completed by {s['completed_ranks']}"
               if s["completed_ranks"] else "")
            + (f"; never entered by {s['never_entered']}"
               if s["never_entered"] else ""))
    if report["suspect_ranks"]:
        lines.append(
            f"suspect rank(s): {report['suspect_ranks']} — "
            f"{report['suspect_reason']}")
    if report["suspect_edges"]:
        lines.append("suspect edges: " + ", ".join(
            f"{a}->{b}" for a, b in report["suspect_edges"]))
    if not report["stuck_rounds"] and not report["missing_ranks"]:
        lines.append("no hung round found: every entered collective round "
                     "also exited on every reporting rank")
    for c in report.get("caveats", []):
        lines.append(f"caveat: {c}")
    for r in report.get("supervisor_restarts", []):
        lines.append(
            f"supervisor restart {r.get('attempt')}: rc "
            f"{r.get('returncode')} after {r.get('uptime_s')}s "
            f"(earlier dumps under restart-{r.get('attempt')}/)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.blackbox",
        description="Merge per-rank blackbox flight-recorder dumps and "
        "diagnose which rank/round wedged a hung decentralized job")
    ap.add_argument("incident_dir",
                    help="directory holding blackbox-rank*.jsonl dumps "
                    "(searched recursively; restart-N/ layers included)")
    ap.add_argument("--expect-ranks", type=int, default=None, metavar="N",
                    help="world size when the dumps alone cannot tell "
                    "(a missing rank is only visible against N)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="also write a merged chrome trace (one pid per "
                    "rank) for Perfetto")
    ap.add_argument("--json", action="store_true",
                    help="emit the full diagnosis as JSON instead of text")
    args = ap.parse_args(argv)

    dumps = load_incident(args.incident_dir)
    if not dumps:
        print(f"bfblackbox: no blackbox-rank*.jsonl found under "
              f"{args.incident_dir}")
        return 1
    report = diagnose(dumps, expect_ranks=args.expect_ranks)
    restarts = load_supervisor_restarts(args.incident_dir)
    if restarts:
        report["supervisor_restarts"] = restarts
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(chrome_trace(dumps), f)
        print(f"bfblackbox: wrote merged chrome trace to {args.trace}")
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(_format_report(report, args.incident_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
