#!/usr/bin/env python3
"""Stress the peer-memory transport's ordering on the card: every call of
``fuse_apply(neighbor_allreduce)`` (exp2 over 8 ranks, K1's peer form)
mixes rows that each hold one known constant, so the result is exact and
any row read before its owner finished packing it shows.  Half the calls
first queue 1-3 f32 4096^3 matmuls in a process, a third sleep up to 3 ms
on the host, at random per process (``delay``); ``plain`` runs the calls
back to back.  Run from the repository root under the launcher:

    python3 -m bluefog_tpu_torch.runtime.launch --no-build -np 4 \\
        tools/transport_stress.py LENGTH CALLS {delay,plain}

Each process prints ``STRESS {json}`` with its count of wrong rows (0
expected) and the first of them.  ``PROBE_DEVICE=cpu`` runs it over gloo.
"""
import json
import os
import random
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

from bluefog_tpu_torch.runtime.launch import initialize_cluster  # noqa: E402

initialize_cluster()

import bluefog_tpu_torch as bf  # noqa: E402
from bluefog_tpu_torch.ops import collectives as C  # noqa: E402
from bluefog_tpu_torch.ops.gossip_kernel import schedule_tables  # noqa: E402
from bluefog_tpu_torch.topology import (  # noqa: E402
    ExponentialTwoGraph, build_schedule)


def main(argv):
    length, calls, mode = int(argv[0]), int(argv[1]), argv[2]
    ctx = bf.init(size=8, device=os.environ.get("PROBE_DEVICE"))
    dev = ctx.device
    m, start = len(ctx.owned_ranks), ctx.owned_ranks.start
    sched = build_schedule(ExponentialTwoGraph(8))
    sw, rw, src = schedule_tables(sched, "cpu")
    rng = random.Random(ctx.process_rank * 7 + 1)
    side = 4096 if dev.type == "cuda" else 256
    big = torch.randn(side, side, device=dev)
    xs = {"a": torch.empty(m, length // 2, device=dev),
          "b": torch.empty(m, length - length // 2, device=dev)}
    bad, first_bad = 0, None
    t0 = time.perf_counter()
    for c in range(calls):
        # small integers: every mix of them is exact in f32
        vals = [float(c * 16 + r) for r in range(8)]
        if mode == "delay" and rng.random() < 0.5:
            for _ in range(rng.randint(1, 3)):
                big = (big @ big) * 1e-3
        if mode == "delay" and rng.random() < 0.3:
            time.sleep(rng.random() * 0.003)
        for x in xs.values():
            for i in range(m):
                x[i].fill_(vals[start + i])
        out = C.fuse_apply(
            lambda t: C.neighbor_allreduce(t, sched, backend="kernel"), xs)
        for i in range(m):
            r = start + i
            want = sw[r].item() * vals[r] + sum(
                rw[r, k].item() * vals[int(src[r, k])]
                for k in range(src.shape[1]) if int(src[r, k]) >= 0)
            for k in xs:
                lo, hi = out[k][i].min().item(), out[k][i].max().item()
                if lo != want or hi != want:
                    bad += 1
                    if first_bad is None:
                        first_bad = [c, r, k, lo, hi, want]
    print("STRESS " + json.dumps({
        "process": ctx.process_rank, "bad": bad, "first_bad": first_bad,
        "calls": calls, "s": time.perf_counter() - t0,
        "handshakes": ctx.transport.handshakes}), flush=True)
    bf.shutdown()
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
