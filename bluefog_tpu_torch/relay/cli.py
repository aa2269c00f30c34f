"""``python -m bluefog_tpu_torch.relay``: run one standalone snapshot relay.

::

    python -m bluefog_tpu_torch.relay HOST:PORT --group name:0 [--group ...]
        [--port N] [--tier T] [--fallback HOST:PORT ...]
        [--degree D] [--full-every N] [--codec topk|f32|none]
        [--ttl SECONDS] [--duration SECONDS]

Subscribes to the upstream serving host (a trainer or another relay) for
every ``--group``, re-publishes them on its own port, and prints one
``RELAY_READY host port`` line once serving (scripts parse it to wire the
next tier).  Runs until ``--duration`` elapses (0 = until interrupted).
Exit codes: 0 clean, 1 relay failed (upstream unreachable beyond every
budget), 2 usage.  The JAX package's ``bfrelay-tpu`` takes the same
arguments.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Tuple

__all__ = ["main"]


def _addr(text: str) -> Tuple[str, int]:
    host, _, port = text.rpartition(":")
    if not host or not port.isdigit():
        raise argparse.ArgumentTypeError(f"{text!r} is not HOST:PORT")
    return host, int(port)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.relay",
        description="Run one snapshot relay: subscribe upstream, "
                    "re-publish downstream.")
    ap.add_argument("upstream", type=_addr,
                    help="upstream serving address HOST:PORT")
    ap.add_argument("--group", action="append", required=True,
                    help="snapshot group to relay (repeatable)")
    ap.add_argument("--host", default="0.0.0.0",
                    help="bind address (default all interfaces)")
    ap.add_argument("--port", type=int, default=0,
                    help="serving port (default ephemeral)")
    ap.add_argument("--tier", type=int, default=1,
                    help="tree tier of this relay (default 1)")
    ap.add_argument("--fallback", action="append", type=_addr,
                    default=[], help="re-parent target when the upstream "
                    "dies (repeatable; cursor preserved)")
    ap.add_argument("--every", type=int, default=1,
                    help="upstream subscription stride (default 1)")
    ap.add_argument("--degree", type=int, default=None,
                    help="fan-out admission limit (default unlimited)")
    ap.add_argument("--full-every", type=int, default=8,
                    help="delta resync-anchor cadence; 1 disables deltas "
                    "(default 8)")
    ap.add_argument("--codec", default="topk", choices=("topk", "f32", "none"),
                    help="delta codec for bulk leaves (default topk)")
    ap.add_argument("--topk-ratio", type=float, default=0.05,
                    help="topk kept-coordinate ratio (default 0.05)")
    ap.add_argument("--ttl", type=float, default=None,
                    help="sweep relay groups idle this many seconds "
                    "(default: never)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="run this long, then exit 0 (default: until "
                    "interrupted)")
    args = ap.parse_args(argv)

    from bluefog_tpu_torch.relay.node import RelayNode
    from bluefog_tpu_torch.runtime.delta import DeltaConfig

    try:
        node = RelayNode(
            args.upstream, args.group, tier=args.tier, host=args.host,
            port=args.port,
            delta=DeltaConfig(full_every=max(1, args.full_every),
                              codec=args.codec, topk_ratio=args.topk_ratio),
            every=args.every, fallbacks=args.fallback, idle_ttl_s=args.ttl)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"relay: {e}", file=sys.stderr)
        return 2
    if args.degree is not None:
        node.server.set_fanout_limit(args.degree)
    host, port = node.address
    print(f"RELAY_READY {host} {port}", flush=True)
    deadline = (time.monotonic() + args.duration
                if args.duration > 0 else None)
    try:
        while deadline is None or time.monotonic() < deadline:
            if node.error is not None:
                print(f"relay: relay failed: {node.error}", file=sys.stderr)
                return 1
            time.sleep(0.2)
        return 0
    except KeyboardInterrupt:
        return 0
    finally:
        node.close()


if __name__ == "__main__":
    sys.exit(main())
