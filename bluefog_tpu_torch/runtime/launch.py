"""``bfrun``: start a training script as several processes, and bring a
process into the cluster.

Counterpart of ``bluefog_tpu/runtime/launch.py`` (``initialize_cluster`` and
``bfrun-tpu``).  The reference's ``bfrun`` builds an ``mpirun -np N -x ENV
...`` command line; the JAX package rendezvouses in
``jax.distributed.initialize``.  Here:

- :func:`initialize_cluster` joins torch.distributed's default process
  group over gloo (``init_method="tcp://..."``).  Gloo is the host control
  plane on the card too: the ranks' rows move through peer memory
  (:mod:`bluefog_tpu_torch.ops.transport`), and gloo carries the handles
  and the handshakes.
- :func:`main` is ``bfrun``::

    python -m bluefog_tpu_torch.runtime.launch -np N [-x NAME[=VALUE]] \\
        script.py [args...]
    python -m bluefog_tpu_torch.runtime.launch -np N -m module [args...]

  It starts ``N`` local processes the way ``torchrun`` does, each with
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT`` set (the rendezvous store, which the
  launcher hosts, so no process races another program for its port), as
  fresh interpreters (the spawn
  start method: no child inherits a CUDA state), and, unless the
  environment sets it, ``OMP_NUM_THREADS`` to the host's cores over ``N``,
  as torchrun limits it.  Where the CUDA toolkit is
  present it builds the kernel library once before the start, so that the
  processes do not all compile it.  If a process exits non-zero, the
  launcher stops the others and exits with that status.

  ``--supervise N`` runs the group under
  :func:`~bluefog_tpu_torch.utils.failure.run_supervised`: when it fails,
  it is started again (a fresh store, a fresh rendezvous) after a bounded
  backoff (``--restart-backoff``, ``--min-uptime``), up to N times, and
  the script resumes from its checkpoint.  ``--timeline FILE`` records
  each process's chrome-trace timeline (``BLUEFOG_TPU_TIMELINE``; over
  several processes ``FILE`` gains a ``.rank<r>`` before its suffix).
  ``--simulate N`` asks for N virtual ranks on the CPU: ``bf.init()``
  then defaults to that size and the CPU (the JAX package's virtual CPU
  devices).
- :func:`interactive_main` is ``ibfrun``, ``python -m
  bluefog_tpu_torch.runtime.ibfrun``: a REPL with the framework brought
  up.
"""

from __future__ import annotations

import argparse
import atexit
import code
import datetime
import logging
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["initialize_cluster", "interactive_main", "main"]

_log = logging.getLogger(__name__)


def _from_env():
    """``(address, world size, rank)`` as the launcher or torchrun set them,
    each None where the environment does not name it."""
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    world, rank = os.environ.get("WORLD_SIZE"), os.environ.get("RANK")
    return (f"{addr}:{port}" if addr and port else None,
            int(world) if world else None, int(rank) if rank else None)


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       initialization_timeout: Optional[int] = None) -> None:
    """Join this process to the cluster: torch.distributed's default group
    over gloo, with ``coordinator_address`` (``host:port`` of process 0's
    store), ``num_processes`` and ``process_id``; each argument not given
    is read from ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``.  ``initialization_timeout`` is in seconds (default 300).  One
    process (``num_processes == 1``), or a process already in a group, is a
    no-op.

    Failure policy, the reference's: when the caller asked for a cluster
    (any argument given), a rendezvous failure raises, since a training job
    silently running undistributed at 1/N scale is the worst outcome.  Only
    a call with every argument taken from the environment may log a warning
    and stay single-process, and one whose environment names no cluster
    does so without trying."""
    import torch.distributed as dist

    if num_processes == 1 or dist.is_initialized():
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    env_addr, env_world, env_rank = _from_env()
    addr = coordinator_address if coordinator_address is not None else env_addr
    world = num_processes if num_processes is not None else env_world
    rank = process_id if process_id is not None else env_rank
    if not explicit and (world is None or world == 1):
        return
    timeout = datetime.timedelta(seconds=initialization_timeout or 300)
    try:
        if addr is None or world is None or rank is None:
            raise ValueError(
                f"incomplete cluster: coordinator={addr}, num_processes="
                f"{world}, process_id={rank}")
        dist.init_process_group("gloo", init_method=f"tcp://{addr}",
                                world_size=world, rank=rank, timeout=timeout)
        # leave the group before the interpreter's teardown: a live gloo
        # group destroyed by static destructors at exit can abort the
        # process ("terminate called without an active exception") after
        # its work is done
        atexit.register(_leave_cluster)
        _log.info("cluster initialized: process %d/%d", rank, world)
    except Exception as e:
        if explicit:
            raise RuntimeError(
                f"cluster rendezvous failed (coordinator={addr}, "
                f"num_processes={world}, process_id={rank}): {e}") from e
        _log.warning("torch.distributed rendezvous skipped (the environment "
                     "names no reachable cluster): %s", e)


def _leave_cluster() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _child_env(env_specs: List[str]) -> dict:
    # the launcher's directory leads the children's import path, as it leads
    # the launcher's own under python -m (the reference runs the script in
    # the launcher's interpreter)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.getcwd()] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    for spec in env_specs:
        if "=" in spec:
            key, val = spec.split("=", 1)
            env[key] = val
        elif spec not in os.environ:
            raise SystemExit(f"-x {spec}: not set in the launching "
                             "environment")
        # a bare `-x NAME` propagates the current value, already in env
    return env


def _prebuild() -> None:
    """Build the kernel library before the processes start, where the CUDA
    toolkit is present (a compile takes seconds to minutes; the processes
    then find it built)."""
    from bluefog_tpu_torch.ops import _build

    if _build.find_nvcc() is not None:
        _build.build()


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


_VALUED = ("-np", "--num-processes", "-x", "--master-port", "--supervise",
           "--restart-backoff", "--min-uptime", "--timeline", "--simulate")


def _timeline_path(path: str, rank: int, nprocs: int) -> str:
    """``path`` for one process; over several, ``<root>.rank<r><ext>``."""
    if nprocs <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.rank{rank}{ext}"


def _apply_common(args, env: dict) -> None:
    """The options the launcher and ``ibfrun`` share, into ``env``."""
    if args.simulate is not None:
        if args.simulate < 1:
            raise SystemExit("--simulate needs N >= 1")
        env["BLUEFOG_TPU_TORCH_SIMULATE"] = str(args.simulate)


def _add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--timeline", default=None, metavar="FILE",
                    help="write a chrome-trace timeline "
                         "(BLUEFOG_TPU_TIMELINE)")
    ap.add_argument("--simulate", type=int, default=None, metavar="N",
                    help="N virtual ranks on the CPU: bf.init() defaults "
                         "to that size and device")


def _split(argv: List[str]):
    """``(launcher's options, target, the target's arguments)``: the target
    is ``-m module`` or the first argument that is no option; everything
    after it belongs to it."""
    for i, tok in enumerate(argv):
        if tok == "-m":
            if i + 1 >= len(argv):
                raise SystemExit("bfrun: -m needs a module")
            return argv[:i], ["-m", argv[i + 1]], argv[i + 2:]
        if not tok.startswith("-") and (i == 0 or argv[i - 1] not in _VALUED):
            return argv[:i], [tok], argv[i + 1:]
    return argv, [], []


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.runtime.launch",
        usage="%(prog)s -np N [-x NAME[=VALUE]] [--master-port PORT] "
              "[--no-build] [--supervise MAX_RESTARTS] [--timeline FILE] "
              "[--simulate N] (script.py | -m module) [args ...]",
        description="Launch a bluefog_tpu_torch script as N local processes "
                    "(bfrun)")
    _add_common_args(ap)
    ap.add_argument("--supervise", type=int, default=None,
                    metavar="MAX_RESTARTS",
                    help="restart the group when it fails, up to "
                         "MAX_RESTARTS times (the script resumes from its "
                         "checkpoint)")
    ap.add_argument("--restart-backoff", type=float, default=2.0,
                    metavar="SECONDS",
                    help="with --supervise: the first restart's delay "
                         "(doubles with jitter, capped; 0 restarts at once)")
    ap.add_argument("--min-uptime", type=float, default=0.0,
                    metavar="SECONDS",
                    help="with --supervise: a run that died sooner earns no "
                         "restart (a crash loop)")
    ap.add_argument("-np", "--num-processes", dest="np", type=int,
                    required=True, help="processes to start")
    ap.add_argument("-x", dest="env", action="append", default=[],
                    metavar="NAME[=VALUE]",
                    help="set or propagate an environment variable "
                         "(mpirun -x)")
    ap.add_argument("--master-port", type=int, default=None,
                    help="port of process 0's store (default: a free one)")
    ap.add_argument("--no-build", action="store_true",
                    help="do not build the kernel library before the start")
    full = list(sys.argv[1:] if argv is None else argv)
    own, target, rest = _split(full)
    args = ap.parse_args(own)
    if args.np < 1:
        ap.error("-np must be at least 1")
    if not target:
        ap.error("a script or -m module is needed")
    if args.supervise is not None:
        if args.supervise < 0:
            ap.error("--supervise needs MAX_RESTARTS >= 0")
        from bluefog_tpu_torch.utils.failure import run_supervised

        # each attempt is this launcher again without --supervise: a fresh
        # store and a fresh rendezvous for every restart
        inner = _without_supervise(own) + target + rest
        return run_supervised(
            [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
             *inner],
            max_restarts=args.supervise, min_uptime_s=args.min_uptime,
            restart_backoff_s=args.restart_backoff)
    env = _child_env(args.env)
    _apply_common(args, env)
    if not args.no_build:
        _prebuild()
    # the launcher hosts the rendezvous store itself, on a port it holds
    # from before the start, and every process joins it as a client (as
    # torchrun's agent does): a free port picked here and bound later by
    # process 0 could be taken in between by any other program on the host
    from torch.distributed import TCPStore

    store = TCPStore("127.0.0.1", args.master_port or 0, args.np,
                     is_master=True, wait_for_workers=False,
                     timeout=datetime.timedelta(seconds=300))
    port = store.port
    env["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    # as torchrun does: the host's cores shared among the processes, unless
    # the caller says otherwise (one process's default of a thread per core
    # oversubscribes the host N times)
    env.setdefault("OMP_NUM_THREADS",
                   str(max(1, (os.cpu_count() or 1) // args.np)))
    procs = []
    for rank in range(args.np):
        child = dict(env, RANK=str(rank), WORLD_SIZE=str(args.np),
                     LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(args.np),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if args.timeline:
            child["BLUEFOG_TPU_TIMELINE"] = _timeline_path(
                os.path.abspath(args.timeline), rank, args.np)
        procs.append(subprocess.Popen([sys.executable, *target, *rest],
                                      env=child))

    def on_signal(signum, frame):
        _stop(procs)
        raise SystemExit(128 + signum)

    old = {s: signal.signal(s, on_signal)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c is not None and c != 0]
            if failed:
                rank, code = failed[0]
                print(f"bfrun: process {rank} exited with status {code}; "
                      "stopping the others", file=sys.stderr)
                _stop(procs)
                return code if code > 0 else 1
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.05)
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def _without_supervise(own: List[str]) -> List[str]:
    """The launcher's own options minus the supervisor's."""
    out, skip = [], False
    for tok in own:
        if skip:
            skip = False
            continue
        name = tok.split("=", 1)[0]
        if name in ("--supervise", "--restart-backoff", "--min-uptime"):
            skip = "=" not in tok
            continue
        out.append(tok)
    return out


def interactive_main(argv: Optional[List[str]] = None) -> int:
    """``ibfrun``: a REPL with the framework brought up (the reference's
    ``ibfrun``; JAX package ``interactive_main``).  Bound names: ``bf``
    (the package), ``torch`` and ``ctx`` (the active context).  Run as
    ``python -m bluefog_tpu_torch.runtime.ibfrun [--simulate N]
    [--topology exp2|ring|grid|star|full] [--size N] [--device D]``; the
    session reads standard input, so a script can be piped in."""
    ap = argparse.ArgumentParser(
        prog="python -m bluefog_tpu_torch.runtime.ibfrun",
        description="Interactive bluefog_tpu_torch session (ibfrun)")
    _add_common_args(ap)
    ap.add_argument("--topology", default="exp2",
                    choices=["exp2", "ring", "grid", "star", "full"],
                    help="initial virtual topology")
    ap.add_argument("--size", type=int, default=None,
                    help="ranks (default: --simulate's N, else 1)")
    ap.add_argument("--device", default=None,
                    help="default: the card, or the CPU under --simulate")
    args = ap.parse_args(argv)
    _apply_common(args, os.environ)
    if args.timeline:
        os.environ["BLUEFOG_TPU_TIMELINE"] = os.path.abspath(args.timeline)
    initialize_cluster()

    import torch

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch import topology as topo_lib
    from bluefog_tpu_torch.parallel.context import simulated_size

    n = args.size or simulated_size() or 1
    builders = {
        "exp2": topo_lib.ExponentialTwoGraph,
        "ring": topo_lib.RingGraph,
        "grid": topo_lib.MeshGrid2DGraph,
        "star": topo_lib.StarGraph,
        "full": topo_lib.FullyConnectedGraph,
    }
    ctx = bf.init(topology=builders[args.topology](n), device=args.device)
    banner = (f"bluefog_tpu_torch interactive: {ctx.size} rank(s) on "
              f"{ctx.device}, topology={args.topology}\n"
              "Bound names: bf (the framework), torch, ctx (the context).")
    code.interact(banner=banner, local={"bf": bf, "torch": torch,
                                        "ctx": ctx})
    return 0


if __name__ == "__main__":
    sys.exit(main())
