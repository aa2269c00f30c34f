"""One rank of the port's SIGSTOP hang-forensics test
(tests/test_torch_blackbox.py), on ``bluefog_tpu_torch`` alone (no JAX).

Each rank process plays a synchronous ring gossip over the port's TCP
windows: per round it records ``collective_begin``, deposits to its ring
neighbours through their window servers, meets the others at a
FileBarrier, records ``collective_end`` and beats its watchdog.  When the
parent SIGSTOPs one rank, the survivors block at the barrier, their
watchdogs time out and write flight-recorder dumps, and ``python -m
bluefog_tpu_torch.blackbox`` must name the stopped rank and the (step,
collective id) it never completed.

argv: rank world barrier_dir steps [slow_rank]
env:  BLUEFOG_TPU_BLACKBOX_DIR (incident dir), set by the parent.
"""

import os
import sys
import time

rank = int(sys.argv[1])
world = int(sys.argv[2])
barrier_dir = sys.argv[3]
steps = int(sys.argv[4])
slow_rank = int(sys.argv[5]) if len(sys.argv) > 5 else -1

os.environ["BLUEFOG_TPU_RANK"] = str(rank)
os.environ["BLUEFOG_TPU_WORLD"] = str(world)

import numpy as np  # noqa: E402

from bluefog_tpu_torch.blackbox import recorder  # noqa: E402
from bluefog_tpu_torch.runtime.async_windows import (  # noqa: E402
    AsyncWindow, FileBarrier)
from bluefog_tpu_torch.runtime.window_server import (  # noqa: E402
    RemoteWindow, WindowServer)
from bluefog_tpu_torch.utils.failure import Heartbeat  # noqa: E402

rec = recorder.get()
assert rec is not None, "blackbox recording must be on for this test"
bar = FileBarrier(barrier_dir, world, rank)
peers = sorted({(rank - 1) % world, (rank + 1) % world})
tag = os.path.basename(barrier_dir)

win = AsyncWindow(f"tbbx{tag}:{rank}", 2, 4, np.float64)
server = WindowServer()
_, port = server.start("127.0.0.1")
tmp = os.path.join(barrier_dir, f"addr.{rank}.tmp")
with open(tmp, "w") as f:
    f.write(str(port))
os.replace(tmp, os.path.join(barrier_dir, f"addr.{rank}"))
bar.wait("created", timeout_s=120)

remotes = {}
for p in peers:
    with open(os.path.join(barrier_dir, f"addr.{p}")) as f:
        remotes[p] = RemoteWindow(("127.0.0.1", int(f.read().strip())),
                                  f"tbbx{tag}:{p}")

hb = Heartbeat(timeout_s=2.5, action="callback")
hb.start()
hb.beat(-1)
print("READY", flush=True)
bar.wait("start", timeout_s=120)

payload = np.full(4, float(rank), np.float64)
for step in range(steps):
    key = ("ring", rank, step)
    rec.begin("collective", key=key, op="ring_round", cid="ring_round#0",
              step=step, rank=rank, peers=peers)
    for p, rw in remotes.items():
        rw.deposit(0 if p == peers[0] else 1, payload, accumulate=True)
    bar.wait(f"round{step}", timeout_s=300)
    rec.end("collective", key=key, op="ring_round", cid="ring_round#0",
            step=step, rank=rank)
    hb.beat(step)
    print(f"STEP {step}", flush=True)
    if rank == slow_rank:
        # a window between rounds for the parent's SIGSTOP to land outside
        # a round
        time.sleep(0.5)

hb.stop()
for rw in remotes.values():
    rw.close()
server.stop()
win.free()
print("DONE", flush=True)
