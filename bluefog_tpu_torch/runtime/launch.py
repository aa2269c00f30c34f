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

Not ported yet: ``--supervise`` and ``--timeline`` (with the host runtime's
failure handling and timeline), ``--simulate`` (the JAX package's virtual CPU
devices), and ``ibfrun``.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["initialize_cluster", "main"]

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
        _log.info("cluster initialized: process %d/%d", rank, world)
    except Exception as e:
        if explicit:
            raise RuntimeError(
                f"cluster rendezvous failed (coordinator={addr}, "
                f"num_processes={world}, process_id={rank}): {e}") from e
        _log.warning("torch.distributed rendezvous skipped (the environment "
                     "names no reachable cluster): %s", e)


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


_VALUED = ("-np", "--num-processes", "-x", "--master-port")


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
              "[--no-build] (script.py | -m module) [args ...]",
        description="Launch a bluefog_tpu_torch script as N local processes "
                    "(bfrun)")
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
    own, target, rest = _split(list(sys.argv[1:] if argv is None else argv))
    args = ap.parse_args(own)
    if args.np < 1:
        ap.error("-np must be at least 1")
    if not target:
        ap.error("a script or -m module is needed")
    env = _child_env(args.env)
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


if __name__ == "__main__":
    sys.exit(main())
