#!/usr/bin/env python3
"""Run chip_smoke.py's phase 1b (ResNet-50 over P = 2 and 4 processes on
the card, with all its checks) N times in one process, after its phase 1
build, as ``main()`` runs it; phase 1c's group, which 1b starts, is
stopped each time.  From the repository root:

    python3 tools/phase_1b_repeat.py N

Prints ``REP i ok`` or ``REP i FAILED`` a run and ``REP k of N passed``;
exits 1 if a run failed.
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bluefog_tpu_torch.ops.collectives import fuse_plan  # noqa: E402


def main(argv):
    n = int(argv[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.phase_build()
    leaves = cs._plan_leaves()
    mp_lengths = [sum(leaves[i][0].numel() for i in idx)
                  for idx in fuse_plan(leaves, None)[0].values()]
    win_len = sum(p[0].numel() for p in leaves)
    ok = 0
    for i in range(n):
        bert_dir = tempfile.TemporaryDirectory()
        t0 = time.perf_counter()
        try:
            _, started = cs.phase_processes(dev, mp_lengths, win_len,
                                            bert_dir.name)
            cs._kill_started([started])
            ok += 1
            print(f"REP {i} ok {time.perf_counter() - t0:.1f} s", flush=True)
        except Exception as e:  # noqa: BLE001 (counted and printed)
            print(f"REP {i} FAILED {e!r}", flush=True)
        bert_dir.cleanup()
    print(f"REP {ok} of {n} passed", flush=True)
    return 0 if ok == n else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
