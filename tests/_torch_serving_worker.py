"""Worker processes of ``tests/test_torch_serving.py`` (the port only; no
JAX is imported here).

argv: <mode> <id> <n_train> <barrier_dir> <duration_s> <name> [target]

modes:
  ``train``      one tcp dsgd rank (id = rank) of
                 ``run_async_dsgd_rank(snapshot_every=1)``, publishing a
                 round-stamped ``(round, x, p)`` snapshot every round.
                 Reader-side chaos (``read:*`` / ``sub:*`` in
                 ``BLUEFOG_TPU_CHAOS``) fires in this process, the serving
                 host, and must not perturb training: rank 0 asserts the
                 push-sum mass audit is exact and that nobody died.
                 Prints ``TRAIN_OK <rank>`` (rank 0 adds ``AUDIT
                 mass=...``).
  ``subscribe``  a reader following trainer ``target``'s group with a
                 resumable Subscriber plus SnapshotClient spot reads,
                 auditing every delivered snapshot exactly: the in-band
                 ``round`` leaf equals the frame's round, rounds strictly
                 increasing across any number of resumes, p > 0 and x
                 finite.  Prints ``SERVE_OK <id> delivered=N resumes=R
                 skipped=S pulled=P``.
  ``train_shm``  one shm dsgd rank with ``snapshot_every=1`` that starts a
                 ``WindowServer`` over its process-global snapshot table
                 and audits its own group through an in-process
                 Subscriber.  Prints ``SHM_OK <rank> frames=N``.
"""

import os
import sys
import time

import numpy as np
import torch


def _read_winaddr(barrier_dir, rank, timeout_s=60.0):
    path = os.path.join(barrier_dir, f"winaddr.{rank}")
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with open(path) as f:
                host, port = f.read().strip().rsplit(":", 1)
            return host, int(port)
        except (FileNotFoundError, ValueError):
            if time.monotonic() > deadline:
                raise RuntimeError(f"no winaddr for rank {rank}")
            time.sleep(0.05)


def _problem(n):
    targets = torch.stack([torch.full((4,), float(r + 1), dtype=torch.float64)
                           for r in range(n)])

    def loss_and_grad(r, step, params):
        diff = params["w"].double() - targets[r]
        return 0.5 * float(diff @ diff), {"w": diff}

    return {"w": torch.zeros(4)}, loss_and_grad


def train(rank, n, barrier_dir, duration_s, name):
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.runtime.resilience import ResilienceConfig
    from bluefog_tpu_torch.topology import FullyConnectedGraph

    params0, loss_and_grad = _problem(n)
    cfg = ResilienceConfig(
        suspect_after_s=0.5, dead_after_s=8.0, reconnect_base_s=0.05,
        reconnect_cap_s=0.3, reconnect_budget=5, seed=rank,
        barrier_timeout_s=60.0)
    report = run_async_dsgd_rank(
        FullyConnectedGraph(n), rank, params0, loss_and_grad,
        barrier=FileBarrier(barrier_dir, n, rank), lr=0.05,
        duration_s=duration_s, skew_s=0.004, name=name, transport="tcp",
        tcp_bind="127.0.0.1", resilience=cfg, snapshot_every=1)
    if rank == 0:
        assert report is not None
        # reader chaos (kills, stalls, torn reads and pushes) leaves the
        # audit identical to a chaos-free run: exact mass, nobody dead
        assert report.dead_ranks == [], report.dead_ranks
        assert abs(report.total_mass - n) <= 1e-9 * n, report.total_mass
        assert min(report.steps_per_rank) > 10, report.steps_per_rank
        assert report.phase_s[0]["publish"] > 0
        print(f"AUDIT mass={report.total_mass!r} "
              f"steps={report.steps_per_rank}", flush=True)
    print(f"TRAIN_OK {rank}", flush=True)


def subscribe(sub_id, n, barrier_dir, duration_s, name, target):
    from bluefog_tpu_torch.serving.client import SnapshotClient
    from bluefog_tpu_torch.serving.subscriber import Subscriber

    addr = _read_winaddr(barrier_dir, target)
    group = f"{name}:{target}"
    sub = Subscriber(addr, group, every=1,
                     reconnect=dict(base_s=0.05, cap_s=0.4, budget=12,
                                    seed=sub_id),
                     idle_timeout_s=4.0, queue_max=64)
    delivered = 0
    last = -1
    # the audit window starts at the first delivered snapshot
    first_deadline = time.monotonic() + 60.0
    deadline = None
    while True:
        if (deadline or first_deadline) <= time.monotonic():
            break
        try:
            snap = sub.get(timeout_s=0.5)
        except RuntimeError:
            break  # the trainer is gone for good (end of run)
        if snap is None:
            continue
        if deadline is None:
            deadline = time.monotonic() + duration_s
        assert snap.round > last, (
            f"duplicate or regressed round {snap.round} after {last}")
        stamp = int(snap.leaves["round"][0])
        assert stamp == snap.round, (
            f"torn snapshot: stamp leaf {stamp} != frame round {snap.round}")
        assert float(snap.leaves["p"][0]) > 0.0
        assert np.isfinite(snap.leaves["x"]).all()
        last = snap.round
        delivered += 1
    resumes, skipped = sub.resumes, sub.skipped_rounds
    sub.close()
    # spot reads through the pull path too: stamped and round-consistent
    client = SnapshotClient(addr, group,
                            retry=dict(budget=8, cap_s=0.4, seed=sub_id))
    pulled = 0
    for _ in range(3):
        try:
            snap = client.snapshot(min_round=1, wait_s=2.0)
        except (RuntimeError, OSError):
            break  # the trainer is already tearing down
        assert int(snap.leaves["round"][0]) == snap.round, snap.round
        pulled += 1
    client.close()
    assert delivered >= 5, f"subscriber {sub_id} delivered {delivered}"
    print(f"SERVE_OK {sub_id} delivered={delivered} resumes={resumes} "
          f"skipped={skipped} pulled={pulled}", flush=True)


def train_shm(rank, n, barrier_dir, duration_s, name):
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.runtime.window_server import WindowServer
    from bluefog_tpu_torch.serving.subscriber import Subscriber
    from bluefog_tpu_torch.topology import FullyConnectedGraph

    params0, loss_and_grad = _problem(n)
    srv = WindowServer()
    addr = srv.start("127.0.0.1")
    audit = {"frames": 0, "bad": 0, "last": -1}

    def check(snap):
        audit["frames"] += 1
        if (int(snap.leaves["round"][0]) != snap.round
                or snap.round <= audit["last"]):
            audit["bad"] += 1
        audit["last"] = snap.round

    sub = Subscriber(addr, f"{name}:{rank}", on_snapshot=check)
    try:
        report = run_async_dsgd_rank(
            FullyConnectedGraph(n), rank, params0, loss_and_grad,
            barrier=FileBarrier(barrier_dir, n, rank), lr=0.05,
            duration_s=duration_s, skew_s=0.004, name=name, transport="shm",
            snapshot_every=1)
    finally:
        time.sleep(0.2)
        sub.close()
        srv.stop()
    assert audit["frames"] >= 5 and audit["bad"] == 0, audit
    if rank == 0:
        assert abs(report.total_mass - n) <= 1e-9 * n, report.total_mass
        print(f"AUDIT mass={report.total_mass!r}", flush=True)
    print(f"SHM_OK {rank} frames={audit['frames']}", flush=True)


def main():
    torch.set_num_threads(1)
    mode = sys.argv[1]
    ident, n = int(sys.argv[2]), int(sys.argv[3])
    barrier_dir, duration_s = sys.argv[4], float(sys.argv[5])
    name = sys.argv[6]
    if mode == "train":
        train(ident, n, barrier_dir, duration_s, name)
    elif mode == "subscribe":
        subscribe(ident, n, barrier_dir, duration_s, name, int(sys.argv[7]))
    elif mode == "train_shm":
        train_shm(ident, n, barrier_dir, duration_s, name)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
