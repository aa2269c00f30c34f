"""``python -m bluefog_tpu_torch.chaos``: run a command under a
deterministic fault spec (the counterpart of the JAX package's
``bfchaos-tpu``).

::

    python -m bluefog_tpu_torch.chaos --spec "server:drop:after_frames=40" \\
        -- python -m bluefog_tpu_torch.examples.async_dsgd_mp --transport tcp
    python -m bluefog_tpu_torch.chaos --spec "rank2:sigkill:at_step=8" --explain
    python -m bluefog_tpu_torch.chaos --grammar

The spec is validated here (a typo fails at once, naming the rule, not
deep inside a worker), exported to the child as ``BLUEFOG_TPU_CHAOS``,
and the child's transport and runner shims do the injecting; the exit
code is the command's.  ``--explain`` prints the parsed rules without
running anything; ``--grammar`` prints the spec grammar.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional

from bluefog_tpu_torch.chaos.spec import GRAMMAR, ChaosSpecError, parse_spec

__all__ = ["main"]

_PROG = "python -m bluefog_tpu_torch.chaos"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog=_PROG,
        description="Run a command under a deterministic "
                    "BLUEFOG_TPU_CHAOS fault spec.")
    ap.add_argument("--spec", default=None,
                    help="chaos spec (see --grammar)")
    ap.add_argument("--explain", action="store_true",
                    help="parse and print the rules, run nothing")
    ap.add_argument("--grammar", action="store_true",
                    help="print the spec grammar and exit")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")
    args = ap.parse_args(argv)

    if args.grammar:
        print(GRAMMAR)
        return 0
    if args.spec is None:
        ap.error("--spec is required (or use --grammar)")
    try:
        rules = parse_spec(args.spec)
    except ChaosSpecError as e:
        print(f"{_PROG}: bad spec: {e}", file=sys.stderr)
        return 2
    if args.explain:
        for i, r in enumerate(rules):
            print(f"rule {i}: {r}")
        return 0
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error(f"no command given ({_PROG} --spec ... -- cmd args)")
    env = dict(os.environ)
    env["BLUEFOG_TPU_CHAOS"] = args.spec
    return subprocess.call(cmd, env=env)


if __name__ == "__main__":
    raise SystemExit(main())
