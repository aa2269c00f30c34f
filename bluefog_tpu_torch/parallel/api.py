"""Array-level op API over rank-stacked tensors: the ``bf.*`` surface.

Counterpart of ``bluefog_tpu/parallel/api.py`` for :func:`rank_stack`, the
stacked-array collectives (:func:`neighbor_allreduce`,
:func:`neighbor_allreduce_aperiodic`, :func:`neighbor_allgather`,
:func:`allreduce`, :func:`allgather`, :func:`broadcast`, :func:`barrier`,
:func:`hierarchical_neighbor_allreduce`),
the parameter-sync helpers of the reference's ``utility.py``
(:func:`broadcast_parameters`, :func:`allreduce_parameters`,
:func:`broadcast_optimizer_state`) and the name-keyed window registry
(``win_create`` ... ``win_update_then_collect``), and the nonblocking
host-op surface on the native engine (:func:`enqueue_host_op`,
:func:`poll`, :func:`synchronize`, :func:`wait_all_host_ops`).  As there, all ranks'
values live in one tensor with a leading ``size``-long rank axis: ``x[r]`` is
rank ``r``'s value.  The ranks are virtual, on the context's one device.
:func:`win_mutex` (with :func:`win_mutex_sweep` and
:func:`win_mutex_break`) guards a named window: a process-local lock in
one process, a leased lock on the launcher's store across processes.

In a context that spans processes every stacked tensor is this process's
owned block of ``m`` ranks (``rank_stack`` makes one), and the collectives
(the aperiodic gossip and ``neighbor_allgather`` too), the parameter-sync
helpers and the windows act on it across the processes (see
:mod:`bluefog_tpu_torch.ops.transport`).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import collectives as _C
from bluefog_tpu_torch.ops import transport as _T
from bluefog_tpu_torch.ops import windows as _W
from bluefog_tpu_torch.parallel.context import get_context
from bluefog_tpu_torch.topology.schedule import GossipSchedule
from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = ["rank_stack", "rank_shard", "neighbor_allreduce", "neighbor_allreduce_aperiodic",
           "neighbor_allgather",
           "allreduce", "allgather", "broadcast", "barrier",
           "hierarchical_neighbor_allreduce", "broadcast_parameters",
           "allreduce_parameters", "broadcast_optimizer_state", "win_create",
           "win_free", "win_put", "win_accumulate", "win_get", "win_update",
           "win_update_then_collect", "enqueue_host_op", "poll",
           "synchronize", "wait_all_host_ops", "win_mutex",
           "win_mutex_sweep", "win_mutex_break"]


def _sched(topology) -> GossipSchedule:
    if topology is None:
        return get_context().schedule
    # a Topology is lowered once per object, keeping its device tables
    return _C._as_schedule(topology)


def rank_stack(x, size: Optional[int] = None, device=None):
    """Replicate a value into the stacked per-rank representation: ``out[r]
    = x`` for every rank (pytree-polymorphic) this process holds: all of
    them in one process, its owned block over several.  Each result is a
    fresh contiguous tensor, detached from ``x``, on ``device`` (default:
    the context's), so ranks can be updated in place independently."""
    if size is None or device is None:
        ctx = get_context()
        size = _T.owned_rows(ctx.size) if size is None else size
        device = ctx.device if device is None else device

    def one(leaf):
        leaf = torch.as_tensor(leaf).detach().to(device)
        return leaf.unsqueeze(0).expand(size, *leaf.shape).clone()

    return pytree.tree_map(one, x)


def rank_shard(x):
    """Place a stacked tree so its rank axis lies on the context (reference
    ``api.py::rank_shard``): every leaf on the context's device; over
    processes, a leaf that carries all ``size`` ranks keeps the rows this
    process owns (a leaf already cut to them stays as it is)."""
    ctx = get_context()
    start, rows = _T.owned_start(ctx.size), _T.owned_rows(ctx.size)

    def one(leaf):
        leaf = torch.as_tensor(leaf).to(ctx.device)
        if leaf.dim() == 0 or leaf.shape[0] not in (ctx.size, rows):
            raise ValueError(f"a stacked leaf has {ctx.size} (or, over "
                             f"processes, {rows}) ranks first; got shape "
                             f"{tuple(leaf.shape)}")
        if leaf.shape[0] == ctx.size and rows != ctx.size:
            leaf = leaf[start:start + rows].contiguous()
        return leaf

    return pytree.tree_map(one, x)


def neighbor_allreduce(x, *, topology=None, self_weight=None,
                       recv_weights=None, send_weights=None,
                       backend: str = "auto"):
    """Stacked-array ``bf.neighbor_allreduce``: ``out[i] = W[i,i] x[i] +
    sum_j W[i,j] x[j]`` with ``W`` from ``topology`` (default: the
    context's).  ``send_weights`` is the reference's per-call
    ``dst_weights``; see :func:`bluefog_tpu_torch.ops.collectives.
    neighbor_allreduce` for the weight shapes and backends."""
    return _C.neighbor_allreduce(x, _sched(topology), self_weight=self_weight,
                                 recv_weights=recv_weights,
                                 send_weights=send_weights, backend=backend)


def neighbor_allreduce_aperiodic(x, mixing_matrix, *,
                                 max_rotations: Optional[int] = None):
    """Stacked-array gossip with an arbitrary per-call topology: ``out = W @
    x`` over the rank axis for any row-stochastic ``(size, size)`` ``W``
    held on the host; edge set and weights may change every call.
    ``max_rotations`` caps the active rotations (more poison the output with
    NaN); see :func:`bluefog_tpu_torch.ops.collectives.
    neighbor_allreduce_aperiodic`.  Over several processes ``x`` is the
    owned block and every process passes the same whole matrix."""
    return _C.neighbor_allreduce_aperiodic(x, mixing_matrix,
                                           max_rotations=max_rotations)


def neighbor_allgather(x: torch.Tensor, *, topology=None):
    """Stacked ``bf.neighbor_allgather``: ``(slots, mask)``; see
    :func:`bluefog_tpu_torch.ops.collectives.neighbor_allgather` for the
    padding to ``K`` slots."""
    return _C.neighbor_allgather(x, _sched(topology))


def allreduce(x, *, average: bool = True):
    """Stacked ``bf.allreduce``: every rank gets the mean (or sum) of all
    ranks' values."""
    return _C.allreduce(x, average=average)


def allgather(x):
    """Stacked ``bf.allgather``: every rank's row becomes the full stack,
    ``(size, size, ...)`` for leaves of shape ``(size, ...)``."""
    return _C.allgather(x)


def broadcast(x, root_rank: int = 0):
    """Stacked ``bf.broadcast``: every rank gets ``root_rank``'s value."""
    return _C.broadcast(x, root_rank)


def barrier() -> bool:
    """Wait for the work queued on the context's device, and over several
    processes for every process."""
    return _C.barrier(get_context().device)


def hierarchical_neighbor_allreduce(x, *, machine_topology=None,
                                    self_weight=None, recv_weights=None,
                                    two_level_mesh: bool = False,
                                    backend: str = "auto"):
    """Stacked ``bf.hierarchical_neighbor_allreduce``: the exact average
    within each machine of ``init(local_size=...)``, then gossip between
    machines along ``machine_topology`` (default: the context's).
    ``two_level_mesh`` selects the reference's ``(machine, local)`` mesh
    form, whose local average does not round bf16/f16 sums to the leaf's
    dtype; see :mod:`bluefog_tpu_torch.ops.collectives`."""
    ctx = get_context()
    msched = machine_topology
    if msched is None:
        if ctx.machine_schedule is None:
            raise RuntimeError(
                "no machine topology: init(local_size=...) first")
        msched = ctx.machine_schedule
    fn = (_C.hierarchical_neighbor_allreduce_2d if two_level_mesh
          else _C.hierarchical_neighbor_allreduce)
    return fn(x, _sched(msched), local_size=ctx.local_size,
              self_weight=self_weight, recv_weights=recv_weights,
              backend=backend)


# ---------------------------------------------------------------------------
# Parameter-sync helpers (reference bluefog/torch/utility.py)
# ---------------------------------------------------------------------------


def broadcast_parameters(params, root_rank: int = 0):
    """Every rank's parameters become ``root_rank``'s (reference
    ``bf.broadcast_parameters``)."""
    return broadcast(params, root_rank)


def allreduce_parameters(params):
    """Every rank's parameters become the ranks' average (reference
    ``bf.allreduce_parameters``); integer leaves keep their dtype."""
    return allreduce(params, average=True)


def broadcast_optimizer_state(state, root_rank: int = 0):
    """Broadcast every rank-stacked tensor of an optimizer state, such as a
    ``torch.optim`` state dict (reference ``bf.broadcast_optimizer_state``).
    Tensors without the context's leading rank axis (a step count) and
    non-tensor entries (hyper-parameters) pass through unchanged."""
    n = _T.owned_rows(get_context().size)

    def one(leaf):
        if (isinstance(leaf, torch.Tensor) and leaf.dim() > 0
                and leaf.shape[0] == n):
            return _C.broadcast(leaf, root_rank)
        return leaf

    return pytree.tree_map(one, state)


# ---------------------------------------------------------------------------
# Window registry (one-sided ops), keyed by name on the context
# ---------------------------------------------------------------------------


def _on_device(x):
    dev = get_context().device
    return pytree.tree_map(lambda t: torch.as_tensor(t).to(dev), x)


def win_create(x, name: str, *, topology=None, zero_init: bool = False
               ) -> bool:
    """Register window ``name`` over the stacked tensor(-tree) ``x``, on the
    context's device (reference ``bf.win_create``)."""
    x = _on_device(x)
    if zero_init:
        x = pytree.tree_map(torch.zeros_like, x)
    get_context().windows[name] = _W.win_create(x, _sched(topology),
                                                name=name)
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Drop one window, or all of them when ``name`` is None (reference
    ``bf.win_free()``), and free its memory: over several processes on the
    card its peer memory now, in every process (collective, see
    :func:`bluefog_tpu_torch.ops.windows.win_free`)."""
    ctx = get_context()
    names = list(ctx.windows) if name is None else [name]
    for key in names:
        state = ctx.windows.pop(key, None)
        if state is not None:
            _W.win_free(state)
    return True


def _get_win(name: str) -> _W.WindowState:
    ctx = get_context()
    if name not in ctx.windows:
        raise KeyError(f"no window named {name!r}; call win_create first")
    return ctx.windows[name]


def win_put(x, name: str, *, dst_weight=1.0) -> bool:
    """Put ``dst_weight * x`` into the out-neighbours' slots of ``name``
    (``x=None``: the window's self buffer)."""
    state = _get_win(name)
    _W.win_put(state, None if x is None else _on_device(x),
               dst_weight=dst_weight)
    return True


def win_accumulate(x, name: str, *, dst_weight=1.0) -> bool:
    """Add ``dst_weight * x`` into the out-neighbours' slots of ``name``."""
    state = _get_win(name)
    _W.win_accumulate(state, None if x is None else _on_device(x),
                      dst_weight=dst_weight)
    return True


def win_get(name: str) -> bool:
    """Pull the in-neighbours' published values into the slots of ``name``."""
    _W.win_get(_get_win(name))
    return True


def win_update(name: str, *, self_weight=None, recv_weights=None):
    """The stacked weighted average of ``name``'s self and landing buffers,
    which also becomes its self buffer (reference ``bf.win_update``)."""
    out, _ = _W.win_update(_get_win(name), self_weight=self_weight,
                           recv_weights=recv_weights)
    return out


def win_update_then_collect(name: str):
    """Sum of ``name``'s self and landing buffers; the slots are zeroed."""
    out, _ = _W.win_update_then_collect(_get_win(name))
    return out


# -- the nonblocking host-op surface (reference bluefog/torch/mpi_ops.py
# poll / synchronize over its handle manager).  The card's work is
# asynchronous on its streams by construction, so the handles here track
# host ops (checkpoint IO, metric flushes) on the engine thread of
# runtime/native.py.


def enqueue_host_op(fn, *, op: str = "host_op", name: str = "") -> int:
    """Run ``fn()`` on the background engine thread; returns a handle."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().enqueue(fn, op=op, name=name)


def poll(handle: int) -> bool:
    """True once the host op behind ``handle`` has completed."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().poll(handle)


def synchronize(handle: int, timeout_s=None):
    """Block until the host op completes and clear its handle (reference
    ``bf.synchronize`` = WaitAndClear).  Raises the op's exception again."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().synchronize(handle, timeout_s=timeout_s)


def wait_all_host_ops(timeout_s=None):
    """Drain every pending host op (before shutdown or a checkpoint)."""
    from bluefog_tpu_torch.runtime.native import engine

    return engine().wait_all(timeout_s=timeout_s)


# ---------------------------------------------------------------------------
# win_mutex: exclusion over a named window (reference api.py:563-897)
# ---------------------------------------------------------------------------

_win_mutexes: dict = {}
_win_mutexes_guard = _lc.lock("parallel.api._win_mutexes_guard")
_dist_held = threading.local()  # per-thread reentrancy counts per name
_store_cache: list = []
_store_guard = _lc.lock("parallel.api._store_guard")

_WIN_MUTEX_PREFIX = "bluefog_tpu/win_mutex/"
# break subkeys live in a disjoint prefix: a lock key derived from a window
# literally named "x.break" can never collide with window "x"'s break key
_WIN_MUTEX_BREAK_PREFIX = "bluefog_tpu/win_mutex_break/"
# every name ever locked, one per line: the sweep's key list
_WIN_MUTEX_REGISTRY = "bluefog_tpu/win_mutex_names"
_LEASE_MARK = " lease_until="
# a value no writer ever stores: compare_set(key, _PROBE, _PROBE) reads a
# key without blocking (the store answers the probe itself when the key is
# absent) and changes nothing
_PROBE = "\x00probe"


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def _coordination_store():
    """The launcher's ``TCPStore`` (``MASTER_ADDR``/``MASTER_PORT``, which
    ``bfrun`` hosts), or None in a one-process job.

    In a job of several processes a missing store is an error, not a
    fallback: a process-local lock would let two processes into the
    critical section, the race win_mutex exists to prevent."""
    if _world_size() <= 1:
        return None
    with _store_guard:
        if _store_cache:
            return _store_cache[0]
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        store = None
        try:
            if addr and port:
                import datetime

                from torch.distributed import TCPStore

                store = TCPStore(addr, int(port), is_master=False,
                                 wait_for_workers=False,
                                 timeout=datetime.timedelta(seconds=60))
            else:
                import torch.distributed as dist

                if dist.is_initialized():
                    store = dist.distributed_c10d._get_default_store()
        except Exception as e:
            raise RuntimeError(
                "win_mutex: a job of several processes but the launcher's "
                "store is unreachable; refusing to downgrade to a "
                "process-local lock") from e
        if store is None:
            raise RuntimeError(
                "win_mutex: a job of several processes (WORLD_SIZE > 1) but "
                "no store: start it under bfrun (MASTER_ADDR/MASTER_PORT) "
                "or initialize torch.distributed; refusing to downgrade to "
                "a process-local lock")
        _store_cache.append(store)
        return store


def _store_get(store, key: str) -> Optional[str]:
    """The key's value, or None when it is absent or released."""
    v = store.compare_set(key, _PROBE, _PROBE)
    v = v.decode() if isinstance(v, bytes) else str(v)
    return None if v in (_PROBE, "") else v


def _store_acquire(store, key: str, value: str) -> Optional[str]:
    """Atomically take ``key`` when it is absent or released; None on
    success, else the holder's value."""
    got = store.compare_set(key, "", value)
    got = got.decode() if isinstance(got, bytes) else str(got)
    return None if got == value else got


def _store_release(store, key: str, expected: str) -> bool:
    """Release ``key`` iff its value is still ``expected`` (an atomic
    compare-and-release: the empty value is free)."""
    got = store.compare_set(key, expected, "")
    got = got.decode() if isinstance(got, bytes) else str(got)
    return got == ""


def _parse_lock_value(v: str):
    """``(owner, lease_expiry_unix_or_None, lease_duration_s_or_None)``
    from a lock key's value (stamp format ``<expiry>[/<duration>]``).
    Values without the lease marker (hand-planted keys) have no lease and
    are never stolen automatically."""
    if _LEASE_MARK in v:
        owner, _, stamp = v.rpartition(_LEASE_MARK)
        expiry, _, dur = stamp.partition("/")
        try:
            return owner, float(expiry), (float(dur) if dur else None)
        except ValueError:
            return v, None, None
    return v, None, None


@contextlib.contextmanager
def win_mutex(name: str = "win", *, for_self: bool = True, ranks=None,
              timeout_s: float = 60.0, poll_interval_s: float = 0.002,
              lease_s: Optional[float] = 30.0):
    """Mutual exclusion over window ``name`` (reference ``bf.win_mutex``,
    an MPI passive-target ``MPI_Win_lock_all`` epoch guarding concurrent
    one-sided access).

    - One process: a process-local reentrant lock per window name (the
      real race there is host threads, engine workers against the main
      thread, mutating the same named window).
    - Several processes (``WORLD_SIZE > 1``): a distributed lock on the
      launcher's ``TCPStore``.  Acquisition is an atomic ``compare_set``
      from empty, release an atomic compare-and-release, and contenders
      poll with a backoff.  Reentrant within a thread; raises
      ``TimeoutError`` after ``timeout_s``.  A job of several processes
      without a store raises: it never downgrades to a local lock.

    Lease and failure semantics (several processes): the lock value
    carries a lease stamp (expiry and duration) that a background
    heartbeat refreshes every ``lease_s/3`` while the holder lives, so a
    live holder is never stolen however long its critical section runs.
    If the holder dies, the next contender recovers the lock.  Stealing
    needs all of: (a) the stamp is expired by the wall clock, (b) the
    contender has watched the value stay unchanged for a full lease on
    its own monotonic clock (so clock skew between hosts alone can never
    steal from a heartbeating holder), and (c) the contender wins the
    atomic break subkey and re-confirms the value unchanged in the same
    atomic compare-and-release that frees it.  Keys without a lease stamp
    are never stolen automatically: :func:`win_mutex_break` clears them
    once their owner is known dead.  ``lease_s=None`` disables the lease.
    A holder frozen (not dead) past its lease can be stolen; its
    refresher sees the loss at its next beat, logs it, and stops.

    ``for_self``/``ranks`` are accepted for the reference's call sites;
    the lock is per window name, not per rank.
    """
    del for_self, ranks  # the lock's granularity is the window name
    store = _coordination_store()
    if store is None:
        with _win_mutexes_guard:
            lock = _win_mutexes.setdefault(
                name, _lc.rlock("parallel.api._win_mutexes[]"))
        with lock:
            yield
        return

    held = getattr(_dist_held, "counts", None)
    if held is None:
        held = _dist_held.counts = {}
    if held.get(name, 0) > 0:  # reentrant within this thread
        held[name] += 1
        try:
            yield
        finally:
            held[name] -= 1
        return

    key = _WIN_MUTEX_PREFIX + name
    owner = (f"{os.environ.get('RANK', '0')}:{os.getpid()}:"
             f"{threading.get_ident()}")

    def stamped():
        if lease_s is None:
            return owner
        return (f"{owner}{_LEASE_MARK}"
                f"{time.time() + lease_s:.3f}/{lease_s:.1f}")

    store.append(_WIN_MUTEX_REGISTRY, name + "\n")
    deadline = time.monotonic() + timeout_s
    backoff = poll_interval_s
    tracker = _StealTracker(store, key, owner)
    mine = stamped()
    while True:
        holder = _store_acquire(store, key, mine)
        if holder is None:
            break
        tracker.poll()
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"win_mutex({name!r}): lock held for {timeout_s:.0f}s by "
                f"{holder!r} (rank:pid:thread); a leased lock recovers "
                "when its owner dies; if this one has no lease and the "
                "owner is dead, recover with win_mutex_break(name)")
        # exponential backoff: N contenders busy-polling the one store
        # would starve its other work
        time.sleep(backoff)
        backoff = min(backoff * 2, 0.1)
        mine = stamped()
    held[name] = 1
    cur = [mine]
    stop_refresh = threading.Event()
    refresher = None
    if lease_s is not None:
        def refresh():
            # a live holder's lease must never lapse: re-stamp well inside
            # the lease period until release.  If the key is no longer
            # ours (stolen from a frozen incarnation of us), say so and
            # stop; a transient store error must not kill the heartbeat
            # (the lease survives two missed beats)
            from bluefog_tpu_torch.utils.logging import log

            while not stop_refresh.wait(lease_s / 3.0):
                try:
                    new = stamped()
                    got = store.compare_set(key, cur[0], new)
                except Exception:
                    continue  # transient: retry at the next beat
                got = got.decode() if isinstance(got, bytes) else str(got)
                if got != new:
                    log.error(
                        "win_mutex(%r): lease lost (key now %r): this "
                        "holder was frozen past its lease and the lock was "
                        "stolen; exclusion is no longer guaranteed for the "
                        "rest of this critical section", name, got)
                    return
                cur[0] = new
        refresher = threading.Thread(target=refresh, daemon=True,
                                     name=f"bf-win-mutex:{name}")
        refresher.start()
    try:
        yield
    finally:
        held[name] = 0
        stop_refresh.set()
        if refresher is not None:
            refresher.join(timeout=5)
        if refresher is not None and refresher.is_alive():
            # a refresher stuck in a store call could re-stamp after our
            # release; leave the key to its lease instead (self-healing)
            from bluefog_tpu_torch.utils.logging import log

            log.warn("win_mutex(%r): refresher still in flight at release; "
                     "leaving the key to its lease", name)
        elif not _store_release(store, key, cur[0]) and lease_s is None:
            # no lease means no self-healing: a failed release is loud
            raise RuntimeError(
                f"win_mutex({name!r}): the key no longer holds this "
                "holder's value at release")


class _StealTracker:
    """Per-contender steal state: recovers a key whose leased holder died.

    Rate-limited (one read per ~lease/10, not per poll), and immune to
    clock skew: stealing also needs the value to have stayed unchanged
    for a full lease on this contender's monotonic clock, which a live
    holder's heartbeat (every lease/3) makes impossible whatever the
    hosts' wall clocks say."""

    def __init__(self, store, key: str, owner: str):
        self.store = store
        self.key = key
        self.owner = owner
        self.observed: Optional[str] = None
        self.first_seen = 0.0   # monotonic time self.observed appeared
        self.next_check = 0.0   # monotonic rate limiter

    def poll(self) -> None:
        now_m = time.monotonic()
        if now_m < self.next_check:
            return
        try:
            cur = _store_get(self.store, self.key)
        except Exception:
            cur = None
        if cur is None:
            self.observed = None
            return  # the key is free: the acquire loop races for it
        if cur != self.observed:
            self.observed, self.first_seen = cur, now_m
        _, expiry, dur = _parse_lock_value(cur)
        if expiry is None:
            self.next_check = now_m + 1.0
            return  # lease-less values are never stolen automatically
        confirm_s = max(1.0, dur if dur is not None else 2.0)
        self.next_check = now_m + max(0.5, confirm_s / 10.0)
        if time.time() <= expiry:
            return  # the writer's clock says live
        if now_m - self.first_seen < confirm_s:
            return  # not yet watched unchanged for a full lease
        if _break_stale(self.store, self.key, self.owner, cur):
            self.observed = None


def _break_stale(store, key: str, breaker: str, observed: str) -> bool:
    """Release ``key`` iff its value is still exactly ``observed``,
    serialised through an atomic break subkey (one breaker at a time).
    True if the stale key was released."""
    now = time.time()
    assert key.startswith(_WIN_MUTEX_PREFIX), key
    bkey = _WIN_MUTEX_BREAK_PREFIX + key[len(_WIN_MUTEX_PREFIX):]
    bval = f"{breaker}{_LEASE_MARK}{now + 10.0:.3f}/10.0"
    try:
        bheld = _store_acquire(store, bkey, bval)
    except Exception:
        return False
    if bheld is not None:
        # the previous breaker may itself have died mid-break
        _, bexp, _ = _parse_lock_value(bheld)
        if bexp is not None and now > bexp:
            try:
                _store_release(store, bkey, bheld)
            except Exception:
                pass
        return False
    stole = False
    try:
        stole = _store_release(store, key, observed)
        if stole:
            from bluefog_tpu_torch.utils.logging import log

            log.warn("win_mutex: broke expired lock %s (was %r)", key,
                     observed)
    except Exception:
        pass
    finally:
        try:
            _store_release(store, bkey, bval)
        except Exception:
            pass
    return stole


def win_mutex_sweep(grace_s: float = 0.0) -> int:
    """Clear every win_mutex key whose lease expired more than ``grace_s``
    ago: the restart path's janitor (a restarted worker calls this before
    it re-enters training, so locks its previous incarnation died holding
    cannot stall the job until a contender's stealing notices).

    Releases go through the same break-subkey and value-unchanged
    protocol as stealing, on a fresh read, so the sweep cannot release a
    lock that was just stolen and re-acquired.  Returns the number of
    keys cleared; 0 in a one-process job."""
    store = _coordination_store()
    if store is None:
        return 0
    try:
        if not store.check([_WIN_MUTEX_REGISTRY]):
            return 0
        raw = store.get(_WIN_MUTEX_REGISTRY)
    except Exception:
        return 0
    names = sorted({n for n in (raw.decode() if isinstance(raw, bytes)
                                else str(raw)).split("\n") if n})
    removed = 0
    now = time.time()
    breaker = f"sweep:{os.getpid()}:{threading.get_ident()}"
    for name in names:
        key = _WIN_MUTEX_PREFIX + name
        try:
            value = _store_get(store, key)
        except Exception:
            continue
        if value is None:
            continue
        _, expiry, _ = _parse_lock_value(value)
        if expiry is not None and now > expiry + grace_s:
            if _break_stale(store, key, breaker, value):
                removed += 1
    return removed


def win_mutex_break(name: str = "win") -> bool:
    """Forcibly release a distributed :func:`win_mutex` whose holder died
    (the ``MPI_Win_unlock_all``-after-failure analog).  True if a held
    lock was cleared.  Call it only when the owner named by the
    ``TimeoutError`` is known dead: breaking a live holder's lock removes
    the exclusion it relies on.  In one process it does nothing (a
    holder's death is the process's death)."""
    store = _coordination_store()
    if store is None:
        return False
    key = _WIN_MUTEX_PREFIX + name
    try:
        value = _store_get(store, key)
        return value is not None and _store_release(store, key, value)
    except Exception:
        return False
