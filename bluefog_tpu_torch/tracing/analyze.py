"""Cross-rank trace merge and per-round critical-path attribution.

Counterpart of ``bluefog_tpu/tracing/analyze.py``, whose reports it
reproduces from the same files.  ``python -m bluefog_tpu_torch.tracing
<trace-dir>`` reads every ``trace-rank*.jsonl`` and ``trace-pid*.jsonl``
under the directory (torn tails tolerated), reconstructs the cross-rank
causal graph from the wire-propagated parent links, and reports:

- **per-round span trees** — each rank's round duration and phase split
  (gossip / compute / publish / control);
- **per-edge phase decomposition** — for every deposit edge ``src ->
  dst``: client-observed wire latency split into the owner-side phases
  the extended ack + server spans expose (recv / queue-wait / apply /
  ack) plus the residual network time;
- **the per-round critical path** — walked backward from the last rank
  to finish each round: at every hop the gate is either the rank's own
  previous round or the latest incoming deposit it consumed, so the
  chain names the **gating edge** and its dominant phase
  (``rank 3 -> rank 0: 62% queue-wait``);
- **overlap fraction** — how much of the wire time was hidden under the
  same rank's compute spans (the progress-through-asynchrony dividend,
  arXiv:2111.04287);
- **straggler ranking** — ranks ordered by mean round duration;
- optionally a merged **chrome trace** whose spans nest the causal
  links (complete events per rank + flow arrows along every
  wire-propagated parent edge) for Perfetto.

The causal join is purely structural: a server-side span's ``par`` is
the sid the sender put in the wire trace header, so ``span[par].rank``
names the source rank with no clock alignment anywhere (timestamps are
only compared WITHIN a rank, plus the explicit cross-rank happens-before
the parent links carry).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

__all__ = ["load_traces", "build_graph", "edge_report", "critical_path",
           "overlap_report", "round_report", "analyze", "chrome_trace",
           "main"]

#: client-side phases of one deposit batch, in pipeline order
CLIENT_PHASES = ("snapshot", "enqueue", "coalesce", "wire", "ack_wait")
#: owner-side phases of one received batch, in pipeline order
SERVER_PHASES = ("recv", "queue_wait", "apply", "ack")


def load_traces(directory: str) -> List[dict]:
    """Every parseable span record under ``directory`` (recursive).
    Torn tails (a crashed writer's final partial line) are skipped, not
    fatal; ``"open": true`` snapshots keep only their NEWEST copy per
    sid (flush re-writes open spans every time)."""
    spans: List[dict] = []
    open_by_sid: Dict[int, dict] = {}
    # trace-rank<k> from rank-pinned trainers, trace-pid<p> from
    # rank-less processes (serving readers) sharing the dir
    paths = sorted(
        glob.glob(os.path.join(directory, "**", "trace-rank*.jsonl"),
                  recursive=True)
        + glob.glob(os.path.join(directory, "**", "trace-pid*.jsonl"),
                    recursive=True))
    for path in paths:
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail
                    if not isinstance(rec, dict) or "sid" not in rec:
                        continue
                    if rec.get("open"):
                        open_by_sid[rec["sid"]] = rec
                    else:
                        spans.append(rec)
                        open_by_sid.pop(rec.get("sid"), None)
        except OSError:
            continue
    spans.extend(open_by_sid.values())
    return spans


def _end(sp: dict) -> float:
    return float(sp.get("t0", 0.0)) + float(sp.get("dur", 0.0) or 0.0)


def _dst_rank(sp: dict) -> Optional[int]:
    """Destination rank of a client wire span when no server spans
    exist: the ``dst`` field is the target window name ``<job>:<rank>``
    (possibly with a sharded ``:ci`` coordinate suffix)."""
    dst = sp.get("dst")
    if not isinstance(dst, str):
        return None
    for part in reversed(dst.split(":")):
        try:
            return int(part)
        except ValueError:
            continue
    return None


def build_graph(spans: List[dict]) -> dict:
    """Index the merged spans: by sid, by (rank, name), and the deposit
    EDGES — ``(src_rank, dst_rank) -> [(wire_span, {phase: server
    span})]``.  An edge exists wherever an owner-side span parents to a
    sender's wire span (the wire-propagated context) or, degraded, from
    the wire span's ``dst`` window name alone."""
    by_sid = {sp["sid"]: sp for sp in spans}
    by_rank_name: Dict[Tuple[Optional[int], str], List[dict]] = \
        defaultdict(list)
    for sp in spans:
        by_rank_name[(sp.get("rank"), sp.get("name", ""))].append(sp)
    for lst in by_rank_name.values():
        lst.sort(key=lambda s: s.get("t0", 0.0))

    # owner-side phases keyed by the wire span they answer
    srv_by_wire: Dict[int, Dict[str, dict]] = defaultdict(dict)
    for sp in spans:
        if sp.get("name") in SERVER_PHASES and sp.get("par"):
            srv_by_wire[sp["par"]][sp["name"]] = sp

    edges: Dict[Tuple[int, int], List[Tuple[dict, Dict[str, dict]]]] = \
        defaultdict(list)
    for sp in spans:
        if sp.get("name") != "wire":
            continue
        src = sp.get("rank")
        srv = srv_by_wire.get(sp["sid"], {})
        dst = None
        for ph in SERVER_PHASES:
            if ph in srv and srv[ph].get("rank") is not None:
                dst = srv[ph]["rank"]
                break
        if dst is None:
            dst = _dst_rank(sp)
        if src is None or dst is None or src == dst:
            continue
        edges[(int(src), int(dst))].append((sp, srv))
    return {"by_sid": by_sid, "by_rank_name": dict(by_rank_name),
            "edges": dict(edges), "spans": spans}


def _mean(vals: List[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0


def edge_report(graph: dict) -> Dict[str, dict]:
    """Per-edge phase decomposition.  ``wire`` is the client-observed
    send->ack latency; the owner-side spans (or the extended-ack
    timings the client folded into the wire span's ``queue_s`` /
    ``apply_s`` fields) split it, and the unattributed residue is the
    network + server frontend (``net``)."""
    out: Dict[str, dict] = {}
    for (src, dst), pairs in sorted(graph["edges"].items()):
        wire = [float(sp.get("dur", 0.0) or 0.0) for sp, _ in pairs]
        phases: Dict[str, List[float]] = {p: [] for p in SERVER_PHASES}
        for sp, srv in pairs:
            for p in SERVER_PHASES:
                if p in srv:
                    phases[p].append(float(srv[p].get("dur", 0.0) or 0.0))
                elif p == "queue_wait" and sp.get("queue_s") is not None:
                    phases[p].append(float(sp["queue_s"]))
                elif p == "apply" and sp.get("apply_s") is not None:
                    phases[p].append(float(sp["apply_s"]))
        w = _mean(wire)
        ph_means = {p: _mean(v) for p, v in phases.items() if v}
        net = max(0.0, w - sum(ph_means.values()))
        decomp = dict(ph_means, net=net)
        total = sum(decomp.values()) or 1.0
        out[f"{src}->{dst}"] = {
            "src": src, "dst": dst, "batches": len(pairs),
            "wire_mean_s": w,
            "wire_p50_s": sorted(wire)[len(wire) // 2] if wire else 0.0,
            "phase_mean_s": decomp,
            "phase_frac": {p: v / total for p, v in decomp.items()},
        }
    return out


def round_report(graph: dict) -> dict:
    """Per-rank round statistics + phase split + straggler ranking."""
    per_rank: Dict[int, dict] = {}
    rounds_seen = set()
    for (rank, name), lst in graph["by_rank_name"].items():
        if name != "round" or rank is None:
            continue
        durs = [float(s.get("dur", 0.0) or 0.0) for s in lst
                if not s.get("open")]
        rounds_seen.update(s.get("round") for s in lst
                           if s.get("round") is not None)
        phases = {}
        for ph in ("gossip", "compute", "publish", "control"):
            sub = graph["by_rank_name"].get((rank, ph), [])
            tot = sum(float(s.get("dur", 0.0) or 0.0) for s in sub
                      if not s.get("open"))
            if sub:
                phases[ph] = tot / max(1, len(durs))
        # round spans emitted by an overlap-enabled runner carry the
        # measured per-round hidden/total fold split
        ovs = [float(s["overlap"]) for s in lst
               if not s.get("open") and s.get("overlap") is not None]
        per_rank[int(rank)] = {
            "rounds": len(durs),
            "round_mean_s": _mean(durs),
            "round_max_s": max(durs) if durs else 0.0,
            "phase_mean_s": phases,
            **({"overlap_mean": _mean(ovs)} if ovs else {}),
        }
    straggler = sorted(per_rank,
                       key=lambda r: -per_rank[r]["round_mean_s"])
    return {"per_rank": per_rank, "rounds_observed": len(rounds_seen),
            "straggler_ranking": straggler}


def overlap_report(graph: dict) -> Dict[int, float]:
    """Per sender rank: fraction of wire time hidden under that rank's
    own compute spans (1.0 = gossip fully overlapped)."""
    out: Dict[int, float] = {}
    ranks = {r for (r, n) in graph["by_rank_name"] if n == "wire"
             and r is not None}
    for rank in sorted(ranks):
        wires = [s for s in graph["by_rank_name"].get((rank, "wire"), [])
                 if not s.get("open")]
        computes = [(float(s["t0"]), _end(s)) for s in
                    graph["by_rank_name"].get((rank, "compute"), [])
                    if not s.get("open")]
        total = hidden = 0.0
        for w in wires:
            w0, w1 = float(w["t0"]), _end(w)
            total += w1 - w0
            for c0, c1 in computes:
                lo, hi = max(w0, c0), min(w1, c1)
                if hi > lo:
                    hidden += hi - lo
        out[int(rank)] = hidden / total if total > 0 else 0.0
    return out


def critical_path(graph: dict, *, max_hops: int = 64) -> dict:
    """Walk the per-round critical chain backward from the last rank to
    finish each round.  At ``(rank d, round k)`` the gate is whichever
    ended latest inside round ``k``'s window: d's own round ``k-1``
    (sequential dependency), the latest incoming deposit edge that
    landed at d (owner-side spans whose destination is d — a slow
    SENDER), or d's own latest outgoing wire span to complete (the
    ack-gate: bounded in-flight backpressure means d's round could not
    close until some peer's server acknowledged — a slow RECEIVER).
    Every cross-rank hop is a named gating edge; THE gating edge is the
    one whose gating consumed the most accumulated wall-clock (wire
    seconds summed over its hops — hop COUNT would crown a fast edge
    that merely fires often over a slow edge that actually stalls
    rounds), reported with its phase decomposition."""
    rounds: Dict[Tuple[int, int], dict] = {}
    for (rank, name), lst in graph["by_rank_name"].items():
        if name != "round" or rank is None:
            continue
        for sp in lst:
            if sp.get("round") is not None and not sp.get("open"):
                rounds[(int(rank), int(sp["round"]))] = sp

    # incoming deposits per destination rank (owner-clock completion)
    # and outgoing wire spans per sender rank (sender-clock ack), both
    # time-sorted — timestamps are only ever compared WITHIN one rank
    incoming: Dict[int, List[Tuple[float, int, dict]]] = defaultdict(list)
    outgoing: Dict[int, List[Tuple[float, int, dict]]] = defaultdict(list)
    for (src, dst), pairs in graph["edges"].items():
        for sp, srv in pairs:
            if "apply" in srv:
                # owner-clock completion — comparable to the owner's
                # own round windows.  WITHOUT owner-side spans (the
                # extended-ack degraded mode) there is no incoming
                # gate: the wire span's end is SENDER-clock, and
                # comparing it to the destination's windows would be
                # exactly the cross-rank clock comparison this module
                # promises never to make (the ack-backpressure gate
                # below still names the edge, sender-clock throughout)
                incoming[dst].append((_end(srv["apply"]), src, sp))
            if sp.get("rank") == src and not sp.get("open"):
                outgoing[src].append((_end(sp), dst, sp))
    for lst in incoming.values():
        lst.sort()
    for lst in outgoing.values():
        lst.sort()

    gate_counts: Dict[Tuple[int, int], int] = defaultdict(int)
    gate_time: Dict[Tuple[int, int], float] = defaultdict(float)
    chains: List[List[dict]] = []
    for k in sorted({r for (_, r) in rounds}):
        at_k = [(rank, sp) for (rank, r), sp in rounds.items() if r == k]
        if not at_k:
            continue
        rank, sp = max(at_k, key=lambda it: _end(it[1]))
        chain: List[dict] = []
        d, rd = rank, k
        for _ in range(max_hops):
            sp = rounds.get((d, rd))
            if sp is None:
                break
            t0 = float(sp["t0"])
            t1 = _end(sp)
            prev = rounds.get((d, rd - 1))
            prev_end = _end(prev) if prev is not None else None
            # the latest deposit that landed AT d inside this round
            gate_in = None
            for t_done, src, wsp in reversed(incoming.get(d, [])):
                if t_done <= t1:
                    if t_done >= t0:
                        gate_in = (t_done, src, wsp)
                    break
            # the latest of d's OWN sends to be acknowledged inside this
            # round — the backpressure gate a slow receiver imposes
            gate_out = None
            for t_ack, dst2, wsp in reversed(outgoing.get(d, [])):
                if t_ack <= t1:
                    if t_ack >= t0:
                        gate_out = (t_ack, dst2, wsp)
                    break
            gate_edge = None  # (t, src, dst, wire span, continue rank)
            if gate_in is not None:
                gate_edge = (gate_in[0], gate_in[1], d, gate_in[2],
                             gate_in[1])
            if gate_out is not None and (
                    gate_edge is None or gate_out[0] > gate_edge[0]):
                # the ack-gate's CAUSE lives at the receiver's server,
                # but its clock lives here: keep walking on d's side
                gate_edge = (gate_out[0], d, gate_out[1], gate_out[2], d)
            if gate_edge is not None and (
                    prev_end is None or gate_edge[0] >= prev_end):
                t_done, src, dst2, wsp, cont = gate_edge
                gate_counts[(src, dst2)] += 1
                gate_time[(src, dst2)] += float(wsp.get("dur", 0.0)
                                                or 0.0)
                chain.append({"hop": "edge", "src": src, "dst": dst2,
                              "round": rd,
                              "gate": ("deposit" if cont != d
                                       else "ack_backpressure"),
                              "wire_s": float(wsp.get("dur", 0.0) or 0.0)})
                if cont != d:
                    # continue on the SENDER's side, at the round the
                    # deposit was sent from (round 0 is a real round —
                    # no falsy-`or` shortcut here)
                    d = cont
                    wr = wsp.get("round")
                    rd = int(wr) if wr is not None else rd
                else:
                    rd -= 1
            elif prev is not None:
                chain.append({"hop": "self", "rank": d, "round": rd})
                rd -= 1
            else:
                break
        chains.append(chain)

    report = {"gate_counts": {f"{s}->{d}": c
                              for (s, d), c in sorted(gate_counts.items())},
              "gate_time_s": {f"{s}->{d}": t
                              for (s, d), t in sorted(gate_time.items())},
              "chains_walked": len(chains)}
    if gate_counts:
        # the edge that gated the most WALL-CLOCK (count breaks ties
        # deterministically): a chatty fast edge must not outrank the
        # slow edge the rounds actually waited on
        (src, dst), _ = max(
            gate_time.items(),
            key=lambda kv: (kv[1], gate_counts[kv[0]], kv[0]))
        report["gating_edge"] = [src, dst]
        report["gating_rounds"] = gate_counts[(src, dst)]
        er = edge_report(graph).get(f"{src}->{dst}")
        if er is not None:
            frac = er["phase_frac"]
            dom = max(frac, key=lambda p: frac[p])
            report["phase_frac"] = frac
            report["dominant_phase"] = dom
            report["dominant_frac"] = frac[dom]
    return report


def analyze(directory: str, *, spans: Optional[List[dict]] = None
            ) -> dict:
    """Full report for a trace dir; pass ``spans`` when the caller
    already loaded them (the CLI does — no double parse of a large
    trace tree)."""
    if spans is None:
        spans = load_traces(directory)
    graph = build_graph(spans)
    return {
        "spans": len(spans),
        "ranks": sorted({s.get("rank") for s in spans
                         if s.get("rank") is not None}),
        "open_spans": sum(1 for s in spans if s.get("open")),
        "rounds": round_report(graph),
        "edges": edge_report(graph),
        "critical_path": critical_path(graph),
        "overlap_fraction": overlap_report(graph),
    }


# ---------------------------------------------------------------------------
# Chrome trace export
# ---------------------------------------------------------------------------

_CAT_LANES = {"dsgd": 0, "tcp": 1, "tcp_srv": 2}


def chrome_trace(spans: List[dict]) -> List[dict]:
    """Merged chrome trace: one pid per rank, one lane per category,
    complete ("X") events so phase nesting renders by time containment,
    and FLOW arrows (s/f) along every cross-rank parent link — the
    causal edges stay visible as arrows in Perfetto."""
    if not spans:
        return []
    by_sid = {s["sid"]: s for s in spans}
    t0 = min(float(s.get("t0", 0.0)) for s in spans)
    out: List[dict] = []
    for rank in sorted({s.get("rank", 0) or 0 for s in spans}):
        out.append({"name": "process_name", "ph": "M", "pid": rank,
                    "args": {"name": f"rank {rank}"}})
    for sp in spans:
        pid = int(sp.get("rank", 0) or 0)
        tid = _CAT_LANES.get(sp.get("cat", ""), 9)
        ts = (float(sp.get("t0", 0.0)) - t0) * 1e6
        ev = {"name": sp.get("name", "span"), "cat": sp.get("cat", "bf"),
              "ph": "X", "ts": ts,
              "dur": float(sp.get("dur", 0.0) or 0.0) * 1e6,
              "pid": pid, "tid": tid,
              "args": {k: v for k, v in sp.items()
                       if k not in ("t0", "dur", "cat", "name")}}
        out.append(ev)
        par = sp.get("par")
        parent = by_sid.get(par) if par else None
        if parent is not None and parent.get("rank") != sp.get("rank"):
            # cross-rank causal link: one flow arrow parent -> child
            pts = (float(parent.get("t0", 0.0)) - t0) * 1e6
            out.append({"name": "causal", "cat": "flow", "ph": "s",
                        "id": sp["sid"], "pid": int(parent.get("rank", 0)
                                                    or 0),
                        "tid": _CAT_LANES.get(parent.get("cat", ""), 9),
                        "ts": pts + float(parent.get("dur", 0.0) or 0.0)
                        * 1e6})
            out.append({"name": "causal", "cat": "flow", "ph": "f",
                        "bp": "e", "id": sp["sid"], "pid": pid,
                        "tid": tid, "ts": ts})
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _pct(x: float) -> str:
    return f"{100.0 * x:.0f}%"


def _format_report(rep: dict, directory: str) -> str:
    lines = [f"bftrace: {rep['spans']} span(s) from ranks "
             f"{rep['ranks']} under {directory}"
             + (f" ({rep['open_spans']} still open)"
                if rep["open_spans"] else "")]
    rr = rep["rounds"]
    for rank in sorted(rr["per_rank"]):
        st = rr["per_rank"][rank]
        ph = ", ".join(f"{p} {v * 1e3:.1f}ms"
                       for p, v in sorted(st["phase_mean_s"].items()))
        lines.append(
            f"rank {rank}: {st['rounds']} round(s), mean "
            f"{st['round_mean_s'] * 1e3:.1f}ms"
            + (f" ({ph})" if ph else "")
            + (f", fold overlap {_pct(st['overlap_mean'])}"
               if "overlap_mean" in st else ""))
    if rr["straggler_ranking"]:
        lines.append("straggler ranking (slowest first): "
                     + ", ".join(map(str, rr["straggler_ranking"])))
    for name, er in rep["edges"].items():
        frac = ", ".join(f"{p} {_pct(v)}"
                         for p, v in sorted(er["phase_frac"].items(),
                                            key=lambda kv: -kv[1]))
        lines.append(
            f"edge {name}: {er['batches']} batch(es), wire mean "
            f"{er['wire_mean_s'] * 1e3:.1f}ms ({frac})")
    cp = rep["critical_path"]
    if cp.get("gating_edge"):
        src, dst = cp["gating_edge"]
        dom = cp.get("dominant_phase")
        lines.append(
            f"CRITICAL PATH: rank {src} -> rank {dst} — "
            f"{cp['gating_rounds']} gating hop(s) across "
            f"{cp['chains_walked']} round chain(s), "
            f"{cp['gate_time_s'][f'{src}->{dst}']:.2f}s of gating "
            "wall-clock"
            + (f": {_pct(cp['dominant_frac'])} {dom}" if dom else ""))
    else:
        lines.append("critical path: no cross-rank gating edge observed "
                     "(rounds gated by local compute)")
    for rank, frac in sorted(rep["overlap_fraction"].items()):
        lines.append(f"overlap rank {rank}: {_pct(frac)} of wire time "
                     "hidden under compute")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.tracing",
        description="Merge per-rank trace JSONL, reconstruct the "
        "cross-rank causal graph, and attribute each round's critical "
        "path to a gating edge + phase")
    ap.add_argument("trace_dir",
                    help="directory holding trace-rank*.jsonl / "
                    "trace-pid*.jsonl files (searched recursively)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="also write a merged chrome trace (complete "
                    "events + causal flow arrows) for Perfetto")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON instead of text")
    args = ap.parse_args(argv)

    spans = load_traces(args.trace_dir)
    if not spans:
        print(f"bftrace: no trace-rank*/trace-pid*.jsonl spans found "
              f"under {args.trace_dir}")
        return 1
    rep = analyze(args.trace_dir, spans=spans)
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(chrome_trace(spans), f)
        print(f"bftrace: wrote merged chrome trace to {args.trace}")
    if args.json:
        print(json.dumps(rep, indent=2, default=str))
    else:
        print(_format_report(rep, args.trace_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
