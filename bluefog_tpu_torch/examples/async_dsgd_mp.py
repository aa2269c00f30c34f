"""Cross-process asynchronous decentralized SGD, self-checking.

Counterpart of ``examples/async_dsgd_mp.py`` of the JAX package.
:mod:`~bluefog_tpu_torch.examples.async_dsgd` runs the reference's
asynchronous execution model (``DistributedWinPutOptimizer``) with rank
threads; this example runs it the way the reference deploys it, one OS
process per rank (``mpirun -np N``): each process creates its landing
window and deposits into its neighbours' windows directly, ``MPI_Put``
across a real process boundary with no receiver involvement and no barrier
in the training loop (:func:`~bluefog_tpu_torch.runtime.async_windows.
run_async_dsgd_rank`).  ``--transport shm`` (default) backs the windows
with named POSIX shared memory (ranks on one host); ``--transport tcp``
serves each rank's windows through its own
:class:`~bluefog_tpu_torch.runtime.window_server.WindowServer` (the
cross-host shape, here on loopback) and deposits through pipelined
batched streams.

Each rank process trains a linear regressor on its own shard of a synthetic
linear problem, its parameters and gradient on the card (``--device cpu``
runs them on the CPU), with deliberately skewed step rates.  The parent
starts this module again once per rank with ``--worker R``, and rank 0
checks its report:

  1. every rank took >= 5 steps and the skew materialised (the fastest
     rank >= 1.5x the steps of the slowest);
  2. push-sum mass is conserved exactly (sum of p == n to 1e-9);
  3. rank 0's loss fell by >= 50%;
  4. the ranks agree: the consensus gap is below 5% of the parameter scale.

``--resilient`` (tcp) arms peer-fault tolerance: reconnect and replay,
and self-healing gossip over a complete graph.  Pair it with the chaos CLI
to watch a rank get SIGKILLed mid-run and the survivors finish anyway::

    python -m bluefog_tpu_torch.chaos --spec "rank2:sigkill:at_step=12" \
        -- python -m bluefog_tpu_torch.examples.async_dsgd_mp --ranks 3 \
        --transport tcp --resilient

The ranks' loops deliver the spec's death (``BLUEFOG_TPU_CHAOS``, which
the CLI exports to every worker); the survivors detect it through their
failing deposit streams (rank 0 checks that the first tombstone came
within ``dead_after_s`` of the victim's last step), heal, and rank 0
checks the audit over the survivors exactly (``total_mass ==
baseline_mass``).  Wire faults (``server:``, ``ack:``, ``client:`` rules)
act on every rank's streams and server the same way.

``--elastic`` (implies tcp and ``--resilient``) runs elastic membership
across processes: ``--ranks`` is the job's capacity, ranks 0 .. N-2
start as its members, rank N-1 joins mid-run (warm-starting from a
member's window, no checkpoint file), and rank 1 drains gracefully at
three quarters of the run, handing its mass off in drain-flagged
deposits.  Rank 0 checks that the join and the leave happened and that
the audit is exact over the final member set.

Run::

  python -m bluefog_tpu_torch.examples.async_dsgd_mp [--ranks 2] \\
      [--duration 3] [--transport shm|tcp] [--resilient] [--elastic] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Sequence

__all__ = ["main", "worker"]


def _chaos_kills() -> Dict[int, int]:
    """The ranks the chaos spec in the environment SIGKILLs, with their
    step (empty without a spec)."""
    from bluefog_tpu_torch import chaos

    inj = chaos.get()
    return {} if inj is None else {
        r.rank: r.at_step for r in inj.rules
        if r.site == "rank" and r.fault == "sigkill"
        and r.at_step is not None}


def worker(rank: int, n: int, bdir: str, duration_s: float, lr: float,
           device: str, transport: str = "shm", resilient: bool = False,
           elastic: bool = False) -> None:
    import numpy as np
    import torch

    from bluefog_tpu_torch.parallel.context import resolve_device
    from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                         run_async_dsgd_rank)
    from bluefog_tpu_torch.runtime.resilience import ResilienceConfig
    from bluefog_tpu_torch.topology import FullyConnectedGraph, RingGraph

    torch.set_num_threads(1)
    dev = resolve_device(device)
    # shard r of a synthetic linear regression y = X @ w* + noise
    rng = np.random.default_rng(1234)
    w_star = rng.standard_normal(16).astype(np.float32)
    X = rng.standard_normal((n * 64, 16)).astype(np.float32)
    y = X @ w_star + 0.01 * rng.standard_normal(n * 64).astype(np.float32)
    Xr = torch.from_numpy(X[rank * 64:(rank + 1) * 64]).to(dev)
    yr = torch.from_numpy(y[rank * 64:(rank + 1) * 64]).to(dev)

    params0 = {"w": torch.zeros(16, device=dev),
               "b": torch.zeros((), device=dev)}
    kills = _chaos_kills()
    last_step = kills.get(rank, 0) - 1

    def loss_and_grad(r, step, params):
        w = params["w"].requires_grad_()
        b = params["b"].requires_grad_()
        loss = torch.mean((Xr @ w + b - yr) ** 2)
        gw, gb = torch.autograd.grad(loss, (w, b))
        if step == last_step:
            # the victim's last step before the chaos spec kills it at
            # the top of the next: the moment rank 0's detection
            # latency is measured from
            with open(os.path.join(bdir, f"killed.{r}"), "w") as f:
                f.write(repr(time.time()))
        return float(loss.detach()), {"w": gw, "b": gb}

    # the pipelined tcp transport's sender and ack threads raise every
    # rank's per-step floor by milliseconds, so its skew must be an order
    # larger to show; the base grows with the rank count, so the skew
    # stays visible above scheduler contention on few cores
    base = 0.004 if transport == "tcp" else 0.0005
    skew_s = base * max(n - 1, 1) * (1.0 + 4.0 * rank / max(n - 1, 1))
    resilience = None
    if resilient:
        resilience = ResilienceConfig(reconnect_base_s=0.05,
                                      reconnect_cap_s=0.3,
                                      reconnect_budget=4, seed=rank,
                                      barrier_timeout_s=60.0)
    # a complete graph gives every survivor a direct stream to the
    # victim, so detection is transport-native on all of them
    topo = (FullyConnectedGraph(n) if resilient and n > 2
            else RingGraph(n))
    elastic_kw = {}
    if elastic:
        if rank == n - 1:
            elastic_kw = dict(join=True)
        else:
            # the drain is late in the run, so the joiner's admission
            # (its start-up takes seconds) settles first: membership
            # events settle one at a time
            elastic_kw = dict(initial_members=list(range(n - 1)),
                              leave_after_s=(0.75 * duration_s
                                             if rank == 1 else None))
    report = run_async_dsgd_rank(
        topo, rank, params0, loss_and_grad,
        barrier=FileBarrier(bdir, n, rank), lr=lr, duration_s=duration_s,
        skew_s=skew_s, name=f"async_dsgd_mp_{os.path.basename(bdir)}",
        transport=transport, tcp_bind="127.0.0.1", resilience=resilience,
        **elastic_kw)

    if rank == 0:
        steps = report.steps_per_rank
        if elastic:
            assert report.dead_ranks == [], report.dead_ranks
            assert report.left_ranks == [1], report.left_ranks
            assert report.joined_ranks == [n - 1], report.joined_ranks
            assert report.baseline_mass is not None, \
                "a membership rendezvous degraded: no exact baseline"
            assert abs(report.total_mass - report.baseline_mass) \
                <= 1e-9 * n, (report.total_mass, report.baseline_mass)
            assert steps[n - 1] >= 5, steps
            assert report.final_params[1] is None
            assert report.final_params[n - 1] is not None
            print(f"steps/rank: {steps}  (rank {n - 1} joined, rank 1 "
                  "drained)")
            print(f"ASYNC_MP_REPORT steps={steps} "
                  f"mass={report.total_mass!r} "
                  f"baseline={report.baseline_mass!r} "
                  f"joined={report.joined_ranks} left={report.left_ranks} "
                  f"gap={report.consensus_gap!r} transport={transport} "
                  f"streams={report.stream_stats} device={dev}")
            print("OK — elastic membership over tcp; audit exact over the "
                  "final member set")
        elif report.dead_ranks or kills:
            assert report.dead_ranks == sorted(kills), report.dead_ranks
            kill_rank = report.dead_ranks[0]
            alive = [r for r in range(n) if r not in report.dead_ranks]
            assert min(steps[r] for r in alive) >= 5, steps
            assert report.baseline_mass is not None, \
                "the heal rendezvous degraded: no exact baseline"
            assert abs(report.total_mass - report.baseline_mass) \
                <= 1e-9 * n, (report.total_mass, report.baseline_mass)
            # detection latency: from the victim's last step to the
            # first survivor's tombstone
            with open(os.path.join(bdir, f"killed.{kill_rank}")) as f:
                t_kill = float(f.read())
            detect_s = os.path.getmtime(
                os.path.join(bdir, f"dead.{kill_rank}")) - t_kill
            assert detect_s <= resilience.dead_after_s, (
                detect_s, resilience.dead_after_s)
            print(f"steps/rank: {steps}  (rank(s) {report.dead_ranks} "
                  "died mid-run; survivors healed and finished)")
            print(f"surviving mass: {report.total_mass:.12f}  "
                  f"(post-heal baseline {report.baseline_mass!r}); declared "
                  f"dead {detect_s:.3f} s after the kill (limit "
                  f"{resilience.dead_after_s} s)")
            print(f"ASYNC_MP_REPORT steps={steps} "
                  f"mass={report.total_mass!r} "
                  f"baseline={report.baseline_mass!r} "
                  f"dead={report.dead_ranks} detect_s={detect_s!r} "
                  f"gap={report.consensus_gap!r} "
                  f"transport={transport} streams={report.stream_stats} "
                  f"device={dev}")
            print(f"OK — survived peer death over {transport}; audit "
                  "exact over the surviving set")
        else:
            assert min(steps) >= 5, f"a rank starved: {steps}"
            assert max(steps) >= 1.5 * min(steps), f"no skew in {steps}"
            assert abs(report.total_mass - n) < 1e-9 * n, report.total_mass
            l0 = report.losses[0]
            assert l0[-1] < 0.5 * l0[0], (l0[0], l0[-1])
            scale = float(np.abs(w_star).max())
            assert report.consensus_gap < 0.05 * scale, \
                report.consensus_gap
            print(f"steps/rank: {steps}  (skewed, barrier-free)")
            print(f"push-sum mass: {report.total_mass:.12f}  "
                  f"(== {n} exactly)")
            print(f"rank-0 loss: {l0[0]:.3f} -> {l0[-1]:.4f}")
            print(f"consensus gap: {report.consensus_gap:.2e}")
            print(f"ASYNC_MP_REPORT steps={steps} mass={report.total_mass!r} "
                  f"loss0={l0[0]!r} loss1={l0[-1]!r} "
                  f"gap={report.consensus_gap!r} transport={transport} "
                  f"streams={report.stream_stats} device={dev}")
            print(f"OK — async DSGD spanned real OS processes over "
                  f"{transport} with no barrier")
    print(f"WORKER_DONE {rank}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--duration", type=float, default=3.0, metavar="SECONDS")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--transport", choices=["shm", "tcp"], default="shm",
                    help="deposit fabric: shm (same host) or tcp (the "
                         "cross-host window server, here on loopback)")
    ap.add_argument("--resilient", action="store_true",
                    help="arm peer-fault tolerance (tcp): reconnect and "
                         "replay, self-healing gossip")
    ap.add_argument("--elastic", action="store_true",
                    help="rank N-1 joins mid-run and rank 1 drains "
                         "(tcp, resilient; --ranks >= 3)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bdir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    kills = _chaos_kills()
    if args.elastic:
        if args.ranks < 3 or kills:
            ap.error("--elastic needs --ranks >= 3 and no chaos sigkill "
                     "rule")
        args.transport = "tcp"
        args.resilient = True
    if args.resilient and args.transport != "tcp":
        ap.error("--resilient requires --transport tcp (detection is "
                 "transport-native on the deposit streams)")
    if kills and (not args.resilient
                  or not all(0 < r < args.ranks for r in kills)):
        ap.error("a chaos sigkill rule needs --resilient and its rank in "
                 "1 .. ranks - 1 (rank 0 is the reporting rank)")

    if args.worker is not None:
        worker(args.worker, args.ranks, args.bdir, args.duration, args.lr,
               args.device, args.transport, args.resilient, args.elastic)
        return 0

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    extra = ["--transport", args.transport]
    if args.resilient:
        extra.append("--resilient")
    if args.elastic:
        extra.append("--elastic")
    with tempfile.TemporaryDirectory() as bdir:
        procs = []
        for r in range(args.ranks):
            if args.elastic and r == args.ranks - 1:
                # the joiner attaches to the running job: its start-up
                # is the real delay before it announces itself
                time.sleep(0.5)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bluefog_tpu_torch.examples."
                 "async_dsgd_mp", "--ranks", str(args.ranks),
                 "--duration", str(args.duration), "--lr", str(args.lr),
                 "--device", args.device, "--worker", str(r),
                 "--bdir", bdir] + extra, env=env))
        try:
            rcs = [p.wait(timeout=120 + args.duration * 4) for p in procs]
        except subprocess.TimeoutExpired:
            # a hung worker (stuck at a barrier because a peer died) must
            # not orphan the rest against a vanishing barrier directory
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            print("FAILED: a worker timed out; all workers killed",
                  file=sys.stderr)
            return 1
    if kills:
        # the victims' deaths are the drill; the verdict is rank 0's,
        # which audits the survivors
        want = [-signal.SIGKILL if r in kills else 0
                for r in range(args.ranks)]
        if rcs != want:
            print(f"FAILED: worker exit codes {rcs}, expected {want}",
                  file=sys.stderr)
            return 1
        print(f"(rank(s) {sorted(kills)} were SIGKILLed by the chaos spec; "
              "survivors audited clean)")
    elif any(rcs):
        print(f"FAILED: worker exit codes {rcs}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
