"""Metrics dashboard CLI: summarize a JSONL metrics file.

::

    python -m bluefog_tpu_torch.metrics.dash m.jsonl
    python -m bluefog_tpu_torch.metrics.dash m.jsonl --match bytes

Counterpart of ``bluefog_tpu/metrics/dash.py`` (the ``bfmetrics-tpu``
console script), reading the same file format, so it summarizes either
package's files.  Reads the per-step snapshot lines
:func:`bluefog_tpu_torch.metrics.export.step` appends (plus the atexit summary line) and prints one row per series:

- counters (``*_total``): the cumulative total, per-step delta mean /
  p50 / p99, and — for byte counters — bytes/step;
- gauges: last value plus per-step mean / p50 / p99;
- histograms: the ``_count``/``_sum``/``_p50``/... expansion series are
  folded back into ONE ``hist`` row **per label set** (count, mean
  observation, reservoir p50/p99) — per-peer
  ``bf_tcp_ack_latency_seconds`` reads as one row per peer instead of
  six suffix rows scattered through the table.

``--since <step>`` restricts the window: counter deltas re-baseline
against the last snapshot BEFORE the window (so the first in-window
delta is honest, not the whole cumulative history), histogram counts
and sums are differenced the same way, and gauge statistics cover only
in-window points.  Reservoir quantiles remain whole-run values (the
registry keeps no per-window reservoir) — the rows mark them so.

``--follow`` is the LIVE half (the missing twin of ``--since``): the
dash re-reads the growing JSONL every ``--interval`` seconds and
re-renders, exiting cleanly when the run's atexit summary line appears
(the file is finished) or on Ctrl-C.  On a TTY each refresh repaints in
place; redirected output gets one frame per refresh (tail-able logs).

Percentiles are over the per-step series, which is what an operator
asking "what does a bad step cost" wants — the registry's own
reservoir quantiles (the ``_p50``/``_p99`` series) answer the
per-*observation* version of the question.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict, List, Optional

from bluefog_tpu_torch.metrics.registry import HIST_SUFFIXES, quantile

__all__ = ["main", "load_series", "summarize"]


def load_series(path: str):
    """Parse a metrics JSONL file into ``(steps, series, summary)``:
    ``steps`` the step indices, ``series`` ``{name: [value per line]}``
    (missing values forward-filled with NaN), ``summary`` the final
    summary snapshot (or None)."""
    steps: List[int] = []
    rows: List[Dict[str, float]] = []
    summary: Optional[Dict[str, float]] = None
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SystemExit(f"{path}:{ln}: not JSON ({e})")
            if rec.get("summary"):
                summary = rec.get("metrics", {})
                continue
            rows.append(rec.get("metrics", {}))
            steps.append(int(rec.get("step", len(steps))))
    names = sorted({n for row in rows for n in row})
    series = {n: [row.get(n, math.nan) for row in rows] for n in names}
    return steps, series, summary


def _is_counter(name: str) -> bool:
    base = name.split("{", 1)[0]
    return base.endswith("_total")


def _deltas(values: List[float], prev: float = 0.0) -> List[float]:
    out = []
    for v in values:
        if math.isnan(v):
            continue
        out.append(max(0.0, v - prev))
        prev = v
    return out


def _hist_parts(name: str):
    """``(base, labels, suffix)`` when ``name`` is one series of a
    histogram's snapshot expansion (``<base><suffix>{labels}``), else
    None.  The base+labels pair is the per-label-value grouping key."""
    bare, brace, labels = name.partition("{")
    for suf in HIST_SUFFIXES:
        if bare.endswith(suf) and len(bare) > len(suf):
            return bare[:-len(suf)], brace + labels, suf
    return None


def _last(values: List[float]) -> float:
    for v in reversed(values):
        if not math.isnan(v):
            return v
    return math.nan


def _fmt(v: Optional[float]) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "-"
    if v and (abs(v) >= 1e6 or abs(v) < 1e-3):
        return f"{v:.3e}"
    if float(v).is_integer():
        return f"{int(v)}"
    return f"{v:.4g}"


def summarize(steps, series, summary=None, *, match: str = "",
              since: Optional[int] = None) -> List[dict]:
    """One summary record per series (the dash table's rows).

    ``since`` keeps only snapshots at step >= it; cumulative values
    (counter totals, histogram counts/sums) are re-baselined against
    the last snapshot BEFORE the window so in-window deltas are honest.
    Histogram expansion series are folded into one ``hist`` row per
    (metric, label set): count, total seconds, mean observation, and
    the reservoir p50/p99 — the per-label-value breakdown that makes
    per-peer latency histograms readable.
    """
    final = summary or {}
    # a run that never called step() still writes the atexit summary —
    # its series must appear (with zero per-step points), not vanish
    series = dict(series)
    for name in final:
        series.setdefault(name, [])
    baseline: Dict[str, float] = {}
    if since is not None:
        i0 = next((i for i, s in enumerate(steps) if s >= since),
                  len(steps))
        for name, values in series.items():
            pre = [v for v in values[:i0] if not math.isnan(v)]
            if pre:
                baseline[name] = pre[-1]
        series = {n: v[i0:] for n, v in series.items()}

    # fold histogram expansions back into per-label-set groups; only a
    # COMPLETE suffix family is a histogram (a freestanding gauge that
    # happens to end in _count must not be swallowed)
    groups: Dict[tuple, Dict[str, str]] = {}
    for name in series:
        parts = _hist_parts(name)
        if parts is not None:
            base, labels, suf = parts
            groups.setdefault((base, labels), {})[suf] = name
    hist_names = set()
    for key, sufs in list(groups.items()):
        if set(sufs) == set(HIST_SUFFIXES):
            hist_names.update(sufs.values())
        else:
            del groups[key]

    out = []
    for name, values in sorted(series.items()):
        if name in hist_names or (match and match not in name):
            continue
        clean = [v for v in values if not math.isnan(v)]
        if not clean and name not in final:
            continue
        if _is_counter(name):
            total = final.get(name, clean[-1] if clean else 0.0)
            per_step = _deltas(values, baseline.get(name, 0.0))
            s = sorted(per_step)
            row = {
                "series": name, "type": "counter", "points": len(clean),
                "total": total,
                "per_step_mean": (sum(per_step) / len(per_step)
                                  if per_step else math.nan),
                "p50": quantile(s, 0.50), "p99": quantile(s, 0.99),
            }
        else:
            s = sorted(clean)
            row = {
                "series": name, "type": "gauge", "points": len(clean),
                "total": final.get(name, clean[-1] if clean else math.nan),
                "per_step_mean": (sum(clean) / len(clean)
                                  if clean else math.nan),
                "p50": quantile(s, 0.50), "p99": quantile(s, 0.99),
            }
        out.append(row)

    for (base, labels), sufs in sorted(groups.items()):
        name = base + labels
        if match and match not in name:
            continue

        def last_of(suf: str) -> float:
            n = sufs[suf]
            v = _last(series[n])
            if math.isnan(v):
                v = final.get(n, math.nan)
            return v

        count = last_of("_count") - baseline.get(sufs["_count"], 0.0)
        total = last_of("_sum") - baseline.get(sufs["_sum"], 0.0)
        out.append({
            # observations + mean are windowed; the reservoir p50/p99
            # are whole-run (the registry keeps no per-window reservoir)
            "series": name, "type": "hist", "points": int(count)
            if not math.isnan(count) else 0,
            "total": total,
            "per_step_mean": total / count if count > 0 else math.nan,
            "p50": last_of("_p50"), "p99": last_of("_p99"),
        })
    return out


def format_table(rows: List[dict]) -> str:
    headers = ("series", "type", "points", "total/last", "per-step mean",
               "p50", "p99")
    table = [headers]
    for r in rows:
        table.append((r["series"], r["type"], str(r["points"]),
                      _fmt(r["total"]), _fmt(r["per_step_mean"]),
                      _fmt(r["p50"]), _fmt(r["p99"])))
    widths = [max(len(row[i]) for row in table) for i in range(len(headers))]
    lines = []
    for i, row in enumerate(table):
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.metrics.dash",
        description="Summarize a bluefog_tpu metrics JSONL file "
                    "(per-metric totals, per-step p50/p99).")
    ap.add_argument("path", help="JSONL file written via "
                    "BLUEFOG_TPU_METRICS=<path> / metrics.export.step()")
    ap.add_argument("--match", default="",
                    help="only show series containing this substring")
    ap.add_argument("--since", type=int, default=None, metavar="STEP",
                    help="only count snapshots from this step on "
                    "(counter/histogram deltas re-baseline against the "
                    "last earlier snapshot)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary rows as JSON instead of a table")
    ap.add_argument("--follow", action="store_true",
                    help="live tail mode: re-read and re-render every "
                    "--interval seconds until the run's summary line "
                    "lands (or Ctrl-C)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--follow refresh period in seconds (default 2)")
    args = ap.parse_args(argv)

    def render_once() -> int:
        try:
            steps, series, summary = load_series(args.path)
        except OSError as e:
            if args.follow:
                # the writer may simply not have created the file yet
                print(f"bfmetrics-tpu: waiting for {args.path} ({e})",
                      flush=True)
                return -1
            print(f"bfmetrics-tpu: {e}", file=sys.stderr)
            return 2
        if not steps and summary is None:
            if args.follow:
                return -1  # nothing yet; keep waiting
            print(f"bfmetrics-tpu: {args.path} has no metric records "
                  "(did the run call metrics.step()?)",
                  file=sys.stderr)
            return 1
        rows = summarize(steps, series, summary, match=args.match,
                         since=args.since)
        if args.json:
            # strict JSON for machine consumers (jq chokes on bare NaN)
            clean = [{k: (None if isinstance(v, float) and math.isnan(v)
                          else v) for k, v in r.items()} for r in rows]
            print(json.dumps(clean, indent=2, allow_nan=False))
            return 0 if summary is not None or not args.follow else -1
        if args.follow and sys.stdout.isatty():
            sys.stdout.write("\x1b[2J\x1b[H")  # repaint in place
        n_steps = len(steps)
        print(f"{args.path}: {n_steps} step record(s), {len(rows)} series"
              + (" (summary line present)" if summary is not None
                 else ""), flush=True)
        print(format_table(rows), flush=True)
        # in follow mode the summary line is the writer's "finished"
        # marker (metrics_stop / atexit): render it one last time, stop
        return 0 if summary is not None or not args.follow else -1

    if not args.follow:
        return render_once()
    try:
        while True:
            rc = render_once()
            if rc >= 0:
                return rc
            time.sleep(max(0.05, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
