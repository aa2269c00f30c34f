"""Merge / report / diff over per-rank profile JSONL.

Counterpart of ``bluefog_tpu/profiling/report.py``.  The file format,
the JAX package's (one JSON object per line, torn tails tolerated):

- ``{"kind": "meta", "rank": k, "pid": p, "hz": h, "t0": t}`` — once
  per file;
- ``{"kind": "window", "t0": a, "t1": b, "rank": k, "hz": h,
  "samples": n, "phases": {phase: n}, "stacks": [[phase, folded, n],
  ...]}`` — one per flush window, ``folded`` being a
  ``frame;frame;frame`` stack string (flamegraph.pl's folded format).

:func:`merge` folds every window across every rank into ONE report
dict; :func:`diff` compares two such reports and names hot-frame
regressions: the A/B gate ``python -m bluefog_tpu_torch.profiling
--diff`` exits on.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = ["load_profiles", "merge", "diff", "top_table",
           "render_folded", "render_svg", "phase_frames"]

#: a frame must hold at least this share of base samples to be eligible
#: as a regression subject (noise floor)
DIFF_MIN_FRAC = 0.01
#: a frame absent from base counts as a regression when it holds at
#: least this share of head samples (a NEW hot frame)
DIFF_NEW_HOT_FRAC = 0.05


def load_profiles(directory: str) -> List[dict]:
    """Every parseable record under ``directory`` (recursive).  Torn
    tails (a crashed writer's final partial line) are skipped, not
    fatal."""
    recs: List[dict] = []
    paths = sorted(
        glob.glob(os.path.join(directory, "**", "profile-rank*.jsonl"),
                  recursive=True)
        + glob.glob(os.path.join(directory, "**", "profile-pid*.jsonl"),
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
                    if isinstance(rec, dict) and rec.get("kind") in (
                            "meta", "window"):
                        recs.append(rec)
        except OSError:
            continue
    return recs


def merge(directory: str, *, records: Optional[List[dict]] = None
          ) -> dict:
    """One report over every rank's windows: total samples, per-phase
    split + attribution fraction, per-frame self/total sample counts,
    and the merged folded stacks (with phase kept as the fold's root
    frame, so flamegraphs group by phase)."""
    if records is None:
        records = load_profiles(directory)
    ranks = sorted({r.get("rank") for r in records
                    if r.get("rank") is not None})
    hz = next((float(r["hz"]) for r in records if r.get("hz")), None)
    samples = 0
    phases: Dict[str, int] = {}
    stacks: Dict[Tuple[str, str], int] = {}
    self_counts: Dict[str, int] = {}
    total_counts: Dict[str, int] = {}
    t0 = t1 = None
    for rec in records:
        if rec.get("kind") != "window":
            continue
        if rec.get("t0") is not None:
            t0 = rec["t0"] if t0 is None else min(t0, rec["t0"])
        if rec.get("t1") is not None:
            t1 = rec["t1"] if t1 is None else max(t1, rec["t1"])
        for ph, n in (rec.get("phases") or {}).items():
            phases[ph] = phases.get(ph, 0) + int(n)
        for entry in rec.get("stacks") or ():
            try:
                ph, folded, n = entry
                n = int(n)
            except (TypeError, ValueError):
                continue
            samples += n
            stacks[(ph, folded)] = stacks.get((ph, folded), 0) + n
            frames = folded.split(";")
            if frames:
                leaf = frames[-1]
                self_counts[leaf] = self_counts.get(leaf, 0) + n
            for fr in set(frames):
                total_counts[fr] = total_counts.get(fr, 0) + n
    attributed = sum(n for ph, n in phases.items() if ph != "other")
    phase_total = sum(phases.values()) or 1
    report = {
        "kind": "bfprof_report",
        "ranks": ranks,
        "hz": hz,
        "samples": samples,
        "wall_s": (round(t1 - t0, 3)
                   if t0 is not None and t1 is not None else None),
        "phases": dict(sorted(phases.items())),
        "phase_frac": {ph: round(n / phase_total, 4)
                       for ph, n in sorted(phases.items())},
        "attributed_frac": round(attributed / phase_total, 4),
        "frames": {fr: {"self": self_counts.get(fr, 0),
                        "total": total_counts.get(fr, 0)}
                   for fr in sorted(set(self_counts) | set(total_counts))},
        "stacks": [[ph, folded, n]
                   for (ph, folded), n in sorted(stacks.items())],
    }
    return report


def top_table(report: dict, n: int = 15, *, by: str = "self"
              ) -> List[Tuple[str, int, float]]:
    """Top-N ``(frame, samples, fraction)`` by self or total samples."""
    total = report.get("samples") or 1
    rows = sorted(report.get("frames", {}).items(),
                  key=lambda kv: (-kv[1].get(by, 0), kv[0]))
    return [(fr, int(c.get(by, 0)), round(c.get(by, 0) / total, 4))
            for fr, c in rows[:n] if c.get(by, 0) > 0]


def phase_frames(report: dict, phase: str, n: int = 10
                 ) -> List[Tuple[str, int]]:
    """Top leaf frames whose samples attributed to ``phase`` — the
    trace-join answer ("the gating edge's wall-clock maps to these
    frames")."""
    counts: Dict[str, int] = {}
    for entry in report.get("stacks") or ():
        ph, folded, cnt = entry
        if ph != phase:
            continue
        leaf = folded[folded.rfind(";") + 1:]
        counts[leaf] = counts.get(leaf, 0) + int(cnt)
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:n]


def render_folded(report: dict, *, with_phase_root: bool = True
                  ) -> str:
    """flamegraph.pl-compatible folded output: ``stack count`` lines.
    With ``with_phase_root`` the phase becomes the root frame, so a
    standard flamegraph groups by phase at its base."""
    agg: Dict[str, int] = {}
    for ph, folded, n in report.get("stacks") or ():
        key = f"{ph};{folded}" if with_phase_root else folded
        agg[key] = agg.get(key, 0) + int(n)
    return "\n".join(f"{stack} {n}"
                     for stack, n in sorted(agg.items())) + "\n"


# ---------------------------------------------------------------------------
# Differential profiles — the regression gate
# ---------------------------------------------------------------------------


def diff(base: dict, head: dict, *, threshold: float = 0.2,
         min_frac: float = DIFF_MIN_FRAC,
         new_hot_frac: float = DIFF_NEW_HOT_FRAC) -> dict:
    """Compare two merged reports by per-frame SELF-sample share.

    A frame regresses when its share of all samples grew by at least
    ``threshold`` RELATIVE to base (0.2 = +20%) while holding at least
    ``min_frac`` of base samples, or when a frame absent from base
    holds at least ``new_hot_frac`` of head samples (a new hot frame).
    Returns ``{ok, regressions, improvements, ...}``: machine-checkable
    and exit-code friendly."""
    bn = base.get("samples") or 0
    hn = head.get("samples") or 0
    if bn <= 0 or hn <= 0:
        raise ValueError("diff needs nonempty base and head reports "
                         f"(samples: base={bn}, head={hn})")
    bframes = base.get("frames", {})
    hframes = head.get("frames", {})
    regressions: List[dict] = []
    improvements: List[dict] = []
    for fr in sorted(set(bframes) | set(hframes)):
        bf = bframes.get(fr, {}).get("self", 0) / bn
        hf = hframes.get(fr, {}).get("self", 0) / hn
        if fr not in bframes or bf == 0.0:
            if hf >= new_hot_frac:
                regressions.append({"frame": fr, "base_frac": 0.0,
                                    "head_frac": round(hf, 4),
                                    "rel_change": None, "new": True})
            continue
        if bf < min_frac:
            continue
        rel = hf / bf - 1.0
        entry = {"frame": fr, "base_frac": round(bf, 4),
                 "head_frac": round(hf, 4), "rel_change": round(rel, 4)}
        if rel >= threshold:
            regressions.append(entry)
        elif rel <= -threshold:
            improvements.append(entry)
    regressions.sort(key=lambda e: -(e["head_frac"] - e["base_frac"]))
    improvements.sort(key=lambda e: e["rel_change"])
    return {"ok": not regressions,
            "threshold": threshold,
            "base_samples": bn, "head_samples": hn,
            "regressions": regressions,
            "improvements": improvements}


# ---------------------------------------------------------------------------
# Self-contained flamegraph SVG (no external flamegraph.pl dependency)
# ---------------------------------------------------------------------------

_SVG_ROW_H = 17
_SVG_WIDTH = 1200
_SVG_FONT = 11


def _color(name: str) -> str:
    """Deterministic warm color per frame name (hash-seeded, the
    flamegraph convention) — same frame, same color, across renders."""
    h = hashlib.blake2b(name.encode(), digest_size=3).digest()
    r = 205 + h[0] % 50
    g = 60 + h[1] % 110
    b = h[2] % 60
    return f"rgb({r},{g},{b})"


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def render_svg(report: dict, *, title: str = "bfprof") -> str:
    """A minimal self-contained flamegraph: phase-rooted merged stacks,
    width proportional to samples, one ``<rect>`` + hover ``<title>``
    per node.  Not interactive beyond hover — the point is a committed
    artifact viewable in any browser with zero tooling."""
    # fold into a tree: node = [children: dict, self+child samples]
    root: list = [{}, 0]
    for ph, folded, n in report.get("stacks") or ():
        node = root
        node[1] += int(n)
        for frame in [ph] + folded.split(";"):
            child = node[0].get(frame)
            if child is None:
                child = node[0][frame] = [{}, 0]
            child[1] += int(n)
            node = child

    total = root[1] or 1
    depth_max = [1]
    cells: List[Tuple[int, float, float, str]] = []  # depth, x, w, name

    def walk(node, depth, x0):
        depth_max[0] = max(depth_max[0], depth)
        x = x0
        for name, child in sorted(node[0].items()):
            w = child[1] / total
            if w * _SVG_WIDTH >= 1.0:  # sub-pixel nodes are noise
                cells.append((depth, x, w, name))
                walk(child, depth + 1, x)
            x += w

    walk(root, 0, 0.0)
    height = (depth_max[0] + 3) * _SVG_ROW_H
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{_SVG_WIDTH}" '
        f'height="{height}" font-family="monospace" '
        f'font-size="{_SVG_FONT}">',
        f'<text x="4" y="{_SVG_ROW_H - 4}">{_esc(title)} — '
        f'{report.get("samples", 0)} samples, attributed '
        f'{report.get("attributed_frac", 0.0):.0%}</text>',
    ]
    for depth, x, w, name in cells:
        px = x * _SVG_WIDTH
        pw = max(1.0, w * _SVG_WIDTH)
        py = height - (depth + 2) * _SVG_ROW_H
        n_samples = int(round(w * total))
        out.append(
            f'<g><rect x="{px:.1f}" y="{py}" width="{pw:.1f}" '
            f'height="{_SVG_ROW_H - 1}" fill="{_color(name)}" '
            f'rx="1"><title>{_esc(name)} — {n_samples} samples '
            f'({w:.1%})</title></rect>'
            + (f'<text x="{px + 2:.1f}" y="{py + _SVG_ROW_H - 5}" '
               f'clip-path="inset(0)">'
               f'{_esc(name[:max(1, int(pw / 7))])}</text>'
               if pw >= 30 else "")
            + "</g>")
    out.append("</svg>")
    return "\n".join(out) + "\n"
