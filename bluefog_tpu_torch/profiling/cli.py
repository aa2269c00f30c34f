"""``python -m bluefog_tpu_torch.profiling``: merge, render and gate
continuous profiles.

Counterpart of ``bluefog_tpu/profiling/cli.py`` (``bfprof-tpu``), with its
modes and exit codes:

- ``DIR``: merge every ``profile-rank*.jsonl`` and ``profile-pid*.jsonl``
  under DIR and print the summary and the top-N self table;
- ``--json``: print the merged report JSON instead (the input ``--diff``
  reads);
- ``--folded``: flamegraph.pl-compatible folded stacks on stdout;
- ``--svg PATH``: a self-contained flamegraph SVG;
- ``--trace TRACEDIR``: join against a trace directory (:mod:`bluefog_tpu_
  torch.tracing`): name the critical path's dominant phase and the
  profile frames behind it;
- ``--diff BASE.json HEAD.json [--threshold 0.2]``: the differential
  gate; exits 3 when a hot frame regressed.

Exit codes: 0 ok, 2 usage or load error, 3 regression detected.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from bluefog_tpu_torch.profiling import report as _rep

__all__ = ["main"]

#: trace critical-path phases → profile phases (the trace speaks span
#: names, the profiler speaks the four-phase vocabulary)
_TRACE_PHASE_MAP = {
    "queue_wait": "net-wait",
    "wire": "net-wait",
    "ack_wait": "net-wait",
    "flush": "net-wait",
    "compute": "compute",
    "round": "compute",
    "gossip": "gossip",
    "consume": "gossip",
    "apply": "gossip",
    "mix": "gossip",
    "publish": "publish",
    "fleet": "publish",
    "control": "publish",
}


def _load_report(path: str) -> dict:
    with open(path) as f:
        rep = json.load(f)
    if not isinstance(rep, dict) or rep.get("kind") != "bfprof_report":
        raise ValueError(f"{path}: not a bfprof_report JSON (generate one "
                         "with `python -m bluefog_tpu_torch.profiling DIR "
                         "--json`)")
    return rep


def _print_summary(rep: dict, top: int, out) -> None:
    ranks = rep.get("ranks") or []
    print(f"bfprof: {rep.get('samples', 0)} samples, "
          f"{len(ranks)} rank(s), hz={rep.get('hz')}, "
          f"wall={rep.get('wall_s')}s", file=out)
    print(f"attributed: {rep.get('attributed_frac', 0.0):.1%}", file=out)
    for ph, frac in sorted((rep.get("phase_frac") or {}).items(),
                           key=lambda kv: -kv[1]):
        print(f"  {ph:<10} {frac:7.1%}", file=out)
    rows = _rep.top_table(rep, top)
    if rows:
        print(f"top {len(rows)} frames by self samples:", file=out)
        for fr, n, frac in rows:
            print(f"  {frac:7.1%} {n:>8}  {fr}", file=out)


def _trace_join(rep: dict, trace_dir: str, out) -> None:
    from bluefog_tpu_torch.tracing import analyze as _an

    spans = _an.load_traces(trace_dir)
    if not spans:
        print(f"trace join: no spans under {trace_dir}", file=out)
        return
    cp = _an.critical_path(_an.build_graph(spans))
    dom = cp.get("dominant_phase")
    prof_phase = _TRACE_PHASE_MAP.get(dom or "", "other")
    print(f"trace join: critical path dominated by span "
          f"'{dom}' ({cp.get('dominant_frac', 0.0):.1%} of gate time "
          f"{cp.get('gate_time_s')}s) -> profile phase "
          f"'{prof_phase}'", file=out)
    frames = _rep.phase_frames(rep, prof_phase)
    if frames:
        total = sum(n for _, n in frames) or 1
        print(f"frames behind '{prof_phase}':", file=out)
        for fr, n in frames:
            print(f"  {n / total:7.1%} {n:>8}  {fr}", file=out)
    else:
        print(f"no profile samples attributed to '{prof_phase}'",
              file=out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.profiling",
        description="merge, render, and gate bluefog continuous "
                    "profiles")
    ap.add_argument("directory", nargs="?",
                    help="directory holding profile-rank*.jsonl files")
    ap.add_argument("--top", type=int, default=15,
                    help="rows in the top-frames table (default 15)")
    ap.add_argument("--json", action="store_true",
                    help="print the merged report JSON")
    ap.add_argument("--folded", action="store_true",
                    help="print flamegraph.pl-compatible folded stacks")
    ap.add_argument("--svg", metavar="PATH",
                    help="write a self-contained flamegraph SVG")
    ap.add_argument("--trace", metavar="TRACEDIR",
                    help="join against a trace directory")
    ap.add_argument("--diff", nargs=2, metavar=("BASE", "HEAD"),
                    help="differential gate over two --json reports")
    ap.add_argument("--threshold", type=float, default=0.2,
                    help="relative self-share growth that counts as a "
                         "regression (default 0.2 = +20%%)")
    args = ap.parse_args(argv)
    out = sys.stdout

    if args.diff:
        if args.directory:
            print("bfprof: --diff takes two report files, not a "
                  "directory", file=sys.stderr)
            return 2
        try:
            base = _load_report(args.diff[0])
            head = _load_report(args.diff[1])
            verdict = _rep.diff(base, head, threshold=args.threshold)
        except (OSError, ValueError) as e:
            print(f"bfprof: {e}", file=sys.stderr)
            return 2
        print(json.dumps(verdict, indent=2, sort_keys=True), file=out)
        if not verdict["ok"]:
            n = len(verdict["regressions"])
            print(f"bfprof: FAIL — {n} frame(s) regressed beyond "
                  f"+{args.threshold:.0%}", file=sys.stderr)
            return 3
        print("bfprof: ok — no hot-frame regression", file=out)
        return 0

    if not args.directory:
        ap.print_usage(sys.stderr)
        print("bfprof: a profile directory (or --diff) is required",
              file=sys.stderr)
        return 2
    rep = _rep.merge(args.directory)
    if not rep["samples"]:
        print(f"bfprof: no profile samples under {args.directory}",
              file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True), file=out)
    elif args.folded:
        out.write(_rep.render_folded(rep))
    else:
        _print_summary(rep, args.top, out)
    if args.svg:
        with open(args.svg, "w") as f:
            f.write(_rep.render_svg(rep, title=args.directory))
        print(f"bfprof: wrote {args.svg}", file=out)
    if args.trace:
        _trace_join(rep, args.trace, out)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
