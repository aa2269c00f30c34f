"""Asynchronous one-sided windows over the native host runtime.

Counterpart of ``bluefog_tpu/runtime/async_windows.py``, inside one host.
The stacked window path (:mod:`bluefog_tpu_torch.ops.windows`) moves the
one-sided dataflow inside one program: every rank steps in lockstep.  The
reference's MPI backend is stronger: ``MPI_Put`` lands in the target's
window with no receiver involvement, so ranks progress at different rates
with no barrier anywhere (upstream ``bluefog/common/mpi_controller.cc``
Win* and its lock/flush epochs).  This module runs that execution model:

- :class:`AsyncWindow`: a rank's landing zone in the native window table
  (``csrc/windows.cc``): per-slot locked buffers with deposit
  (put/accumulate), reads that consume exactly once, and deposit counts
  that make staleness visible.  Within a process the ranks are threads and
  a "remote" write is a memory deposit into the target's entry; across
  processes on a host the same table lives in named POSIX shared memory
  (``shm=True`` / ``attach=True``, robust process-shared mutexes).
- :class:`TreePacker`: the bridge from the card to the window and back.
  It packs a dict (or any pytree) of tensors into one contiguous host
  vector and unpacks it: on the card one ``torch.cat`` of the flattened
  f32 leaves and one copy into a pinned host buffer the packer owns, and
  back one narrow cast, one copy to the card and a split there.
- :func:`run_async_pushsum`: rank threads run push-sum at rank-dependent
  rates, depositing weighted (x, p) mass into the neighbours' windows and
  consuming whatever has landed whenever they step.  Mass is conserved
  exactly under any interleaving, and every ``x / p`` reaches the mean.
- :func:`run_async_dsgd` / :class:`AsyncWinPutOptimizer`: asynchronous
  decentralized training on that foundation (subgradient-push, Nedić and
  Olshevsky), the execution model of the reference's
  ``DistributedWinPutOptimizer``; :func:`run_async_dsgd_rank` runs one rank
  per OS process over shared memory or over TCP
  (:mod:`bluefog_tpu_torch.runtime.window_server`), across hosts.
- Peer-fault tolerance (``resilience=``, :mod:`bluefog_tpu_torch.runtime.
  resilience`) and elastic membership (``join_at_s=``/``leave_at_s=`` in
  threads, ``join=``/``leave_after_s=``/``initial_members=`` across
  processes, :mod:`bluefog_tpu_torch.runtime.membership`) in both runners.
- Chaos (:mod:`bluefog_tpu_torch.chaos`): the rank loops consult
  ``check_step`` every step (a thread's ``die``, ``stall`` and ``leave``,
  a process's ``sigkill`` and ``sigstop``) and ``join_times`` at start.
  A thread runner's ``step_hook`` injects the same faults by hand
  (:class:`RankKilled`).
- The communication control plane (``control=``,
  :mod:`bluefog_tpu_torch.control`) in both runners, and the transport
  autotuner (``stream_options['transport_tuning']``) over processes.

- Serve while training (``snapshot_every=``) in both runners: every Nth
  step a rank publishes its round-stamped ``(x, p, round)`` into the
  process-global :class:`~bluefog_tpu_torch.serving.snapshots.
  SnapshotTable` under ``f"{name}:{rank}"``, which any
  :class:`~bluefog_tpu_torch.runtime.window_server.WindowServer` of the
  process serves to :mod:`bluefog_tpu_torch.serving` readers.

- Causal tracing (:mod:`bluefog_tpu_torch.tracing`): the process rank
  body's ``round``, ``gossip``, ``compute``, ``control`` and ``publish``
  spans, stamped with the round, which the deposit streams carry onto the
  wire; and the sampling profiler (``profile=``,
  :mod:`bluefog_tpu_torch.profiling`) in both runners.

- Observability, with the JAX package's names: the windows' deposit and
  read counters, the runners' round, membership and overlap metrics
  (:mod:`bluefog_tpu_torch.metrics`), the flight recorder's per-round
  ``collective`` begin/end, ``optimizer_step`` and membership events
  (:mod:`bluefog_tpu_torch.blackbox`), and named locks for the lock-order
  tripwire (:mod:`bluefog_tpu_torch.utils.lockcheck`); none of them
  changes a result.

Deferred, raising ``NotImplementedError`` that names its ROADMAP item: the
fleet health plane (``fleet=``, item 11).
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional,
                    Sequence, Tuple)

import numpy as np

from bluefog_tpu_torch import chaos as _chaos
from bluefog_tpu_torch.blackbox import recorder as _bb
from bluefog_tpu_torch.control import CommController as _CommController
from bluefog_tpu_torch.control import EvidenceBoard as _EvidenceBoard
from bluefog_tpu_torch.control import evidence as _ctlev
from bluefog_tpu_torch.control.transport import (
    TransportConfig as _TransportConfig, TransportPlan as _TransportPlan,
    decide_transport_plan as _decide_transport_plan)
from bluefog_tpu_torch.metrics import comm as _mt
from bluefog_tpu_torch.metrics.health import MixingTracker as _MixingTracker
from bluefog_tpu_torch.profiling import sampler as _profiling
from bluefog_tpu_torch.runtime import membership as _mship
from bluefog_tpu_torch.runtime import native as _native
from bluefog_tpu_torch.runtime import resilience as _res
from bluefog_tpu_torch.serving import snapshots as _snapshots
from bluefog_tpu_torch.topology.graphs import heal as _heal
from bluefog_tpu_torch.topology.graphs import replan as _replan
from bluefog_tpu_torch.tracing import recorder as _tr
from bluefog_tpu_torch.utils import lockcheck as _lc
from bluefog_tpu_torch.utils import timeline as _timeline

if TYPE_CHECKING:
    from bluefog_tpu_torch.topology.graphs import Topology

# torch is imported where tensors are handled (TreePacker, the rank
# loops), so a process that only opens windows and deposits into them, a
# peer over shm, does not load it

__all__ = [
    "AsyncWindow",
    "TreePacker",
    "run_async_pushsum",
    "run_async_dsgd",
    "run_async_dsgd_rank",
    "AsyncWinPutOptimizer",
    "PushSumReport",
    "DSGDReport",
    "DoubleBuffer",
    "FileBarrier",
    "RankKilled",
    "shm_unlink_window",
]

_DTYPES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


def _not_ported(arg: str, item: str, what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{arg} is not ported yet: it comes with ROADMAP Queue 1 item "
        f"{item} ({what})")


@contextlib.contextmanager
def _host_span(name: str):
    """A B/E timeline span in a per-thread lane (tid = thread ident): rank
    threads deposit into the windows concurrently, and same-name spans of
    different threads must not mis-nest in one lane.  A no-op when no
    timeline is recording."""
    tl = _timeline.current()
    if tl is None:
        yield
        return
    tid = threading.get_ident() % 1_000_000
    tl.begin(name, "async_window", tid)
    try:
        yield
    finally:
        tl.end(name, "async_window", tid)


class _PyWinTable:
    """The pure-Python twin of ``csrc/windows.cc`` (process-local windows
    only), used when the caller asks for it."""

    def __init__(self):
        self._mu = _lc.lock("runtime.async_windows._PyWinTable._mu")
        self._wins: Dict[str, dict] = {}

    def create(self, name, n_slots, n_elems, dtype):
        with self._mu:
            if name in self._wins:
                return -2
            self._wins[name] = {
                "self": np.zeros(n_elems, dtype),
                "self_mu": _lc.lock(
                    "runtime.async_windows._PyWinTable.self_mu"),
                "slots": [{"mu": _lc.lock(
                    "runtime.async_windows._PyWinTable.slot_mu"),
                           "buf": np.zeros(n_elems, dtype),
                           "deposits": 0, "fresh": 0}
                          for _ in range(n_slots)],
            }
            return 0

    def _get(self, name):
        with self._mu:
            return self._wins.get(name)

    def info(self, name):
        """``(n_slots, n_elems, dtype)`` or None (the window server's
        geometry check)."""
        w = self._get(name)
        if w is None:
            return None
        return len(w["slots"]), w["self"].size, w["self"].dtype

    def free(self, name):
        with self._mu:
            return 0 if self._wins.pop(name, None) is not None else -1

    def deposit(self, name, slot, arr, accumulate):
        w = self._get(name)
        if w is None or not (0 <= slot < len(w["slots"])):
            return -1
        s = w["slots"][slot]
        with s["mu"]:
            if accumulate:
                s["buf"] += arr
            else:
                s["buf"][:] = arr
            s["deposits"] += 1
            s["fresh"] += 1
            return s["deposits"]

    def read(self, name, slot, consume, out=None):
        w = self._get(name)
        if w is None or not (0 <= slot < len(w["slots"])):
            return None, -1
        s = w["slots"][slot]
        with s["mu"]:
            if out is None:
                out = s["buf"].copy()
            else:
                out[:] = s["buf"]
            fresh = s["fresh"]
            if consume:
                s["buf"][:] = 0
                s["fresh"] = 0
            return out, fresh

    def fresh(self, name, slot):
        w = self._get(name)
        if w is None or not (0 <= slot < len(w["slots"])):
            return -1
        s = w["slots"][slot]
        with s["mu"]:
            return s["fresh"]

    def set_self(self, name, arr):
        w = self._get(name)
        if w is None:
            return -1
        with w["self_mu"]:
            w["self"][:] = arr
        return 0

    def read_self(self, name):
        w = self._get(name)
        if w is None:
            return None
        with w["self_mu"]:
            return w["self"].copy()


_py_table: Optional[_PyWinTable] = None
_py_table_mu = _lc.lock("runtime.async_windows._py_table_mu")


def _py_windows() -> _PyWinTable:
    global _py_table
    with _py_table_mu:
        if _py_table is None:
            _py_table = _PyWinTable()
        return _py_table


class AsyncWindow:
    """A rank's passive-target window: a self buffer and one landing slot
    per in-neighbour, in process-global memory, so any thread (a peer rank
    on the same host, an engine worker) can deposit without this rank's
    participation.

    With ``shm=True`` the window lives in named POSIX shared memory
    (``csrc/windows.cc`` create/attach_shm): the owner process creates its
    landing zone and peer processes attach the same name and deposit into
    it, ``MPI_Put`` across a process boundary.  ``attach=True`` opens a
    window another process owns (its geometry is read from the segment;
    ``n_slots``/``n_elems``/``dtype`` are ignored), spinning up to
    ``attach_timeout_s`` for the owner, so the order of create and attach
    between processes is free.  Shared memory needs the native table.

    ``native=False`` (or ``BLUEFOG_TPU_TORCH_NO_NATIVE``) puts a
    process-local window in the Python twin of the table.

    Flat f32/f64 vectors; callers pack trees and low-precision leaves
    themselves (:class:`TreePacker`).
    """

    def __init__(self, name: str, n_slots: int = 0, n_elems: int = 0,
                 dtype=np.float32, *, shm: bool = False, attach: bool = False,
                 attach_timeout_s: float = 10.0,
                 native: Optional[bool] = None):
        self.name = name
        self.shm = bool(shm or attach)
        use_native = _native.enabled() if native is None else native
        if self.shm and not use_native:
            raise RuntimeError(
                "cross-process (shm) windows need the native table "
                "(process-shared robust mutexes); unset "
                f"{_native.NO_NATIVE_ENV} or pass native=True")
        self._lib = _native.load() if use_native else None
        if attach:
            rc = self._lib.bf_win_attach_shm(
                name.encode(), int(attach_timeout_s * 1000))
            if rc == -2:
                raise ValueError(
                    f"window {name!r} already open in this process")
            if rc != 0:
                raise RuntimeError(
                    f"attach to shm window {name!r} failed ({rc}): owner "
                    f"did not publish within {attach_timeout_s}s?")
            ns, ne, dt = ctypes.c_int(), ctypes.c_longlong(), ctypes.c_int()
            self._lib.bf_win_info(name.encode(), ctypes.byref(ns),
                                  ctypes.byref(ne), ctypes.byref(dt))
            self.n_slots = ns.value
            self.n_elems = int(ne.value)
            self.dtype = np.dtype(np.float64 if dt.value == 1
                                  else np.float32)
            return
        self.n_slots = n_slots
        self.n_elems = int(n_elems)
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPES:
            raise TypeError(f"AsyncWindow supports f32/f64, got {self.dtype}")
        if self.shm:
            rc = self._lib.bf_win_create_shm(
                name.encode(), n_slots, self.n_elems, _DTYPES[self.dtype])
            if rc == -2:
                raise ValueError(
                    f"shm window {name!r} already exists (live duplicate or "
                    "stale segment from a crashed run — "
                    "shm_unlink_window() cleans the latter)")
            if rc != 0:
                raise RuntimeError(f"bf_win_create_shm({name!r}) failed: {rc}")
        elif self._lib is not None:
            rc = self._lib.bf_win_create(
                name.encode(), n_slots, self.n_elems, _DTYPES[self.dtype])
            if rc == -2:
                raise ValueError(f"window {name!r} already exists")
            if rc != 0:
                raise RuntimeError(f"bf_win_create({name!r}) failed: {rc}")
        else:
            rc = _py_windows().create(name, n_slots, self.n_elems,
                                      self.dtype)
            if rc == -2:
                raise ValueError(f"window {name!r} already exists")

    @property
    def native(self) -> bool:
        return self._lib is not None

    def _check(self, arr: np.ndarray) -> np.ndarray:
        a = np.ascontiguousarray(arr, dtype=self.dtype).ravel()
        if a.size != self.n_elems:
            raise ValueError(f"size {a.size} != window n_elems {self.n_elems}")
        return a

    def deposit(self, slot: int, arr: np.ndarray, *,
                accumulate: bool = True) -> int:
        """Land a payload in ``slot`` (MPI_Accumulate when ``accumulate``,
        MPI_Put otherwise).  Callable from any thread; never waits for the
        window's owner.  Returns the slot's deposit count."""
        a = self._check(arr)
        op = "win_accumulate" if accumulate else "win_put"
        with _host_span(f"{op}.{self.name}"):
            if self._lib is None:
                v = _py_windows().deposit(self.name, slot, a, accumulate)
            else:
                v = self._lib.bf_win_deposit(
                    self.name.encode(), slot, a.ctypes.data, self.n_elems,
                    1 if accumulate else 0)
        if v < 0:
            raise RuntimeError(f"deposit into {self.name!r}[{slot}] failed")
        # per-window deposit volume and count: the "bytes gossiped" of the
        # asynchronous execution model (no-ops with metrics off), and the
        # recorder's last deposits before a wedge
        nbytes = a.size * a.dtype.itemsize
        _mt.inc("bf_window_deposit_bytes_total", nbytes, window=self.name,
                transport="shm" if self.shm else "local")
        _mt.inc("bf_window_deposits_total", 1.0, window=self.name, op=op)
        _bb.record("window_deposit", window=self.name, slot=slot,
                   bytes=nbytes, op=op)
        return int(v)

    def deposit_async(self, slot: int, arr: np.ndarray, *,
                      accumulate: bool = True, copy: bool = True,
                      drain: bool = False) -> int:
        """The pipelined transports' spelling of :meth:`deposit`, so one
        loop body (``deposit_async`` + :meth:`flush` fence) runs on every
        transport.  In-process and shm deposits have landed when the call
        returns, so this is the synchronous deposit; ``copy`` and
        ``drain`` (a graceful leaver's handoff, a wire flag on the TCP
        transport) change nothing here but its record."""
        del copy
        if drain:
            _mt.inc("bf_drain_deposits_total", 1.0, peer="local")
            _bb.record("drain_deposit", window=self.name, slot=slot,
                       peer="local")
        return self.deposit(slot, arr, accumulate=accumulate)

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Fence for :meth:`deposit_async`: nothing is ever in flight."""

    def ack_ewma(self) -> Optional[float]:
        """Wire-transport parity: memory deposits have no ack channel."""
        return None

    @property
    def reconnects(self) -> int:
        """Wire-transport parity: memory never reconnects."""
        return 0

    def set_codec(self, codec: Optional[str]) -> None:
        """Wire-transport parity: only ``None``/``"none"`` is accepted."""
        if codec not in (None, "none"):
            raise ValueError(
                f"in-process/shm windows have no wire codec; cannot set "
                f"{codec!r}")

    def read(self, slot: int, *, consume: bool = True,
             out: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
        """Read a landing slot; ``consume`` zero-fills it afterwards (mass
        is consumed exactly once).  Returns ``(value, deposits since the
        last consuming read)``: 0 means the content is stale.  ``out``, a
        contiguous ``(n_elems,)`` array of the window's dtype, receives
        the value in place of a new array (a rank loop reuses one, so that
        no read of a model-sized slot pays for fresh pages)."""
        if out is not None and (out.shape != (self.n_elems,)
                                or out.dtype != self.dtype
                                or not out.flags.c_contiguous):
            raise ValueError(f"out must be a contiguous ({self.n_elems},) "
                             f"{self.dtype} array")
        with _host_span(f"win_update.{self.name}"):
            if self._lib is None:
                out, fresh = _py_windows().read(self.name, slot, consume,
                                                out)
                if out is None:
                    fresh = -1
            else:
                if out is None:
                    out = np.empty(self.n_elems, self.dtype)
                fresh = self._lib.bf_win_read(
                    self.name.encode(), slot, out.ctypes.data, self.n_elems,
                    1 if consume else 0)
        if fresh < 0:
            raise RuntimeError(f"read of {self.name!r}[{slot}] failed")
        # deposit staleness: the fresh count of each read, and the stale
        # consumes (0 fresh: the rank outruns its in-neighbours)
        _mt.observe("bf_window_fresh_per_read", float(fresh),
                    window=self.name)
        if consume and fresh == 0:
            _mt.inc("bf_window_stale_reads_total", 1.0, window=self.name)
        _bb.record("window_read", window=self.name, slot=slot,
                   fresh=int(fresh), consume=consume)
        return out, int(fresh)

    def fresh(self, slot: int) -> int:
        """Deposits into ``slot`` since its last consuming read, without
        copying the slot (a harvester reads only slots where mass
        landed)."""
        if self._lib is None:
            fresh = _py_windows().fresh(self.name, slot)
        else:
            fresh = self._lib.bf_win_fresh(self.name.encode(), slot)
        if fresh < 0:
            raise RuntimeError(f"fresh of {self.name!r}[{slot}] failed")
        return int(fresh)

    def set_self(self, arr: np.ndarray) -> None:
        """Publish this rank's value (what passive ``win_get`` readers
        see)."""
        a = self._check(arr)
        if self._lib is None:
            rc = _py_windows().set_self(self.name, a)
        else:
            rc = self._lib.bf_win_set_self(self.name.encode(), a.ctypes.data,
                                           self.n_elems)
        if rc != 0:
            raise RuntimeError(f"set_self of {self.name!r} failed")

    def read_self(self) -> np.ndarray:
        if self._lib is None:
            out = _py_windows().read_self(self.name)
            if out is None:
                raise RuntimeError(f"read_self of {self.name!r} failed")
            return out
        out = np.empty(self.n_elems, self.dtype)
        if self._lib.bf_win_read_self(self.name.encode(), out.ctypes.data,
                                      self.n_elems) != 0:
            raise RuntimeError(f"read_self of {self.name!r} failed")
        return out

    def free(self) -> None:
        if self._lib is None:
            _py_windows().free(self.name)
        else:
            self._lib.bf_win_free(self.name.encode())


# One process-wide pool for TreePacker's parallel leaf casts (np.copyto and
# astype release the GIL), shared by every packer so that concurrent rank
# loops do not multiply idle threads.
_CAST_WORKERS = min(8, os.cpu_count() or 1)
_cast_pool_obj = None
_cast_pool_mu = _lc.lock("runtime.async_windows._cast_pool_mu")


def _cast_pool():
    global _cast_pool_obj
    with _cast_pool_mu:
        if _cast_pool_obj is None:
            from concurrent.futures import ThreadPoolExecutor

            _cast_pool_obj = ThreadPoolExecutor(max_workers=_CAST_WORKERS)
        return _cast_pool_obj


def _leaf_dtype(leaf):
    """A leaf's dtype: ``torch.dtype`` for tensors, ``np.dtype`` else."""
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return np.dtype(getattr(leaf, "dtype", None) or np.asarray(leaf).dtype)


def _host_array(leaf) -> np.ndarray:
    """A leaf on the host as numpy, its values exact (bf16 widens to f32,
    which holds every bf16 value)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


class TreePacker:
    """Pack a dict (or any pytree) of tensors or numpy arrays into ONE
    contiguous host vector and back: the bridge that lets model parameters
    ride the window table, whose buffers are flat f32/f64.

    Leaves keep the template's order (``torch.utils._pytree``: a dict in
    insertion order, so a module's ``state_dict`` in module order).
    :meth:`unpack` returns leaves of the template's kind: tensors with the
    template leaf's dtype on its device, numpy arrays where the template
    has numpy.

    The fused path, taken when every leaf is a CUDA tensor of f32, f16 or
    bf16 (through an f32 wire these are exact): :meth:`pack` flattens each
    leaf to f32 and concatenates them on the card (``torch.cat``), copies
    the result once, non-blocking, into a pinned host buffer the packer
    owns, waits for that copy on the current stream, and widens it on the
    host into the vector.  :meth:`unpack` narrows the vector to f32 into a
    second pinned buffer, copies it to a fresh buffer on the card (the next
    unpack first waits for that copy before it overwrites the pinned
    buffer), and splits it there.  Each thread has its own pinned buffers,
    so rank threads sharing one packer never share a buffer.  Any other
    tree, a packer built with ``fused=False``, or a spec-aware packer
    takes the per-leaf host path: each leaf comes to the host and is
    cast-copied into its slice (integer leaves stay exact on the f64 wire).

    ``sharding`` (a :class:`bluefog_tpu_torch.sharding.mesh.ShardView`)
    makes the packer spec-aware: :meth:`pack` takes only the coordinate's
    shard of each sharded leaf (replicated leaves whole), so the vector is
    shard-local, the wire unit of gossip of meshes, and :meth:`unpack`
    returns shard-shaped leaves.  ``pack`` accepts the full tree (it slices
    the shard out) or a shard-shaped one.
    """

    def __init__(self, template, dtype=np.float64, *, sharding=None,
                 fused: bool = True):
        import torch
        from torch.utils import _pytree as pytree

        leaves, self._treedef = pytree.tree_flatten(template)
        self._full_shapes = [tuple(np.shape(l)) if not isinstance(
            l, torch.Tensor) else tuple(l.shape) for l in leaves]
        self.sharding = sharding
        if sharding is not None:
            spec_flat = sharding.spec_leaves(template)
            self._shapes = [tuple(sharding.leaf_shape(s, sp))
                            for s, sp in zip(self._full_shapes, spec_flat)]
            self._slices = [sharding.leaf_slices(s, sp)
                            for s, sp in zip(self._full_shapes, spec_flat)]
        else:
            self._shapes = self._full_shapes
            self._slices = None
        self._sizes = [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
        self._dtypes = [_leaf_dtype(l) for l in leaves]
        self._devices = [l.device if isinstance(l, torch.Tensor) else None
                         for l in leaves]
        self.size = int(sum(self._sizes))
        self.dtype = np.dtype(dtype)
        self._offs = np.cumsum([0] + self._sizes)
        devs = {d for d in self._devices}
        self.device = (next(iter(devs)) if len(devs) == 1 and None not in devs
                       and next(iter(devs)).type == "cuda" else None)
        f32_safe = (torch.float32, torch.float16, torch.bfloat16)
        self._fusable = (fused and sharding is None and self.device is not None
                         and all(dt in f32_safe for dt in self._dtypes))
        self._tls = threading.local()

    @property
    def fused(self) -> bool:
        """Whether pack and unpack take the fused path on the card."""
        return self._fusable

    def _pinned(self, kind: str):
        import torch

        buf = getattr(self._tls, kind, None)
        if buf is None:
            buf = torch.empty(self.size, dtype=torch.float32,
                              pin_memory=True)
            setattr(self._tls, kind, buf)
        return buf

    def pack(self, tree, out: Optional[np.ndarray] = None) -> np.ndarray:
        import torch
        from torch.utils import _pytree as pytree

        leaves = pytree.tree_leaves(tree)
        if len(leaves) != len(self._sizes):
            raise ValueError(
                f"tree has {len(leaves)} leaves, template {len(self._sizes)}")
        vec = np.empty(self.size, self.dtype) if out is None else out
        if vec.shape != (self.size,) or vec.dtype != self.dtype:
            raise ValueError(f"out must be ({self.size},) {self.dtype}")
        if self._fusable and all(isinstance(l, torch.Tensor)
                                 and l.device == self.device for l in leaves):
            # a wrong-shaped leaf must raise, not land at the wrong offsets
            for l, s in zip(leaves, self._shapes):
                if tuple(l.shape) != s:
                    raise ValueError(
                        f"leaf shape {tuple(l.shape)} != template {s}")
            with torch.no_grad():
                flat = torch.cat([l.detach().reshape(-1).to(torch.float32)
                                  for l in leaves])
            host = self._pinned("pack_buf")
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()  # the host reads the buffer next
            # the widen to the wire's dtype: torch's copy runs on its
            # intra-op threads, numpy's on one
            torch.from_numpy(vec).copy_(host)
            return vec
        self._scatter(vec, leaves)
        return vec

    def _scatter(self, vec: np.ndarray, leaves) -> None:
        """Cast-copy each leaf into its slice of ``vec``; in parallel for
        large trees (np.copyto releases the GIL).  A spec-aware packer
        slices this coordinate's shard out of a full-shaped leaf here
        (shard-shaped leaves pass through); any other shape raises."""
        def one(i, leaf):
            a = _host_array(leaf)
            if self._slices is not None:
                if tuple(a.shape) == self._full_shapes[i]:
                    a = np.ascontiguousarray(a[self._slices[i]])
                elif tuple(a.shape) != self._shapes[i]:
                    raise ValueError(
                        f"leaf {i} shape {tuple(a.shape)} is neither the "
                        f"full template shape {self._full_shapes[i]} nor "
                        f"the shard shape {self._shapes[i]}")
            np.copyto(vec[self._offs[i]:self._offs[i + 1]],
                      a.reshape(-1), casting="unsafe")

        if len(leaves) > 1 and self.size >= (1 << 20) and _CAST_WORKERS > 1:
            list(_cast_pool().map(lambda ia: one(*ia), enumerate(leaves)))
        else:
            for i, a in enumerate(leaves):
                one(i, a)

    def unpack(self, vec: np.ndarray):
        import torch
        from torch.utils import _pytree as pytree

        vec = np.asarray(vec)
        if vec.shape != (self.size,):
            raise ValueError(f"vector shape {vec.shape} != ({self.size},)")
        if self._fusable:
            host = self._pinned("unpack_buf")
            pending = getattr(self._tls, "unpack_done", None)
            if pending is not None:
                pending.synchronize()  # the last copy out of `host` is done
            if vec.flags.writeable:
                host.copy_(torch.from_numpy(vec))  # the narrow, threaded
            else:
                np.copyto(host.numpy(), vec, casting="unsafe")
            flat = torch.empty(self.size, dtype=torch.float32,
                               device=self.device)
            flat.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._tls.unpack_done = done
            leaves = [piece.view(shape).to(dt) for piece, shape, dt in zip(
                torch.split(flat, self._sizes), self._shapes, self._dtypes)]
            return pytree.tree_unflatten(leaves, self._treedef)

        def cut(i):
            piece = vec[self._offs[i]:self._offs[i + 1]].reshape(
                self._shapes[i])
            dt = self._dtypes[i]
            if isinstance(dt, torch.dtype):
                return torch.tensor(piece, dtype=dt, device=self._devices[i])
            return piece.astype(dt)

        if (len(self._sizes) > 1 and self.size >= (1 << 20)
                and _CAST_WORKERS > 1):
            leaves = list(_cast_pool().map(cut, range(len(self._sizes))))
        else:
            leaves = [cut(i) for i in range(len(self._sizes))]
        return pytree.tree_unflatten(leaves, self._treedef)


def _create_windows(name: str, slots_per_rank: Sequence[int],
                    n_elems: int, *, native: Optional[bool] = None
                    ) -> List[AsyncWindow]:
    """One window per rank; the ones already created are freed if a later
    creation fails (a name collision with an earlier run, say), so a partial
    failure leaves nothing behind in the process-global table."""
    wins: List[AsyncWindow] = []
    try:
        for r, slots in enumerate(slots_per_rank):
            wins.append(AsyncWindow(f"{name}:{r}", slots, n_elems,
                                    np.float64, native=native))
    except BaseException:
        for w in wins:
            w.free()
        raise
    return wins


class RankKilled(Exception):
    """Raised from a thread runner's ``step_hook`` (or a rank's
    ``loss_and_grad``) to kill that rank thread mid-run: the in-process
    counterpart of a SIGKILLed rank process, as a chaos ``die`` rule's
    :class:`~bluefog_tpu_torch.chaos.ChaosKill` is.  The rank stops
    without a drain or a final publish; the runner writes its push-sum
    mass off as ``died_mass``, so the survivors' audit stays exact."""


@dataclass
class PushSumReport:
    """Outcome of an asynchronous push-sum run."""

    converged: bool
    wall_time_s: float
    steps_per_rank: List[int]
    estimates: np.ndarray      # (n_ranks, n_elems)
    true_mean: np.ndarray      # (n_elems,)
    max_abs_err: float
    total_mass: float          # sum of p over ranks; must stay == n_ranks
    # fault-tolerant runs: ranks declared DEAD and the push-sum mass they
    # carried to the grave (audit invariant: total_mass + died_mass == n)
    dead_ranks: List[int] = field(default_factory=list)
    died_mass: float = 0.0
    # per-rank health transition log [(t, from_state, to_state)] from the
    # shared board
    health_transitions: Optional[Dict[int, list]] = None


def run_async_pushsum(
    topology: Topology,
    x0: np.ndarray,
    *,
    skew: Optional[Sequence[float]] = None,
    tol: float = 1e-3,
    timeout_s: float = 30.0,
    name: str = "async_pushsum",
    poll_interval_s: float = 0.002,
    resilience: Optional[_res.ResilienceConfig] = None,
    step_hook: Optional[Callable[[int, int], None]] = None,
    native: Optional[bool] = None,
) -> PushSumReport:
    """Asynchronous push-sum over ``topology`` with deliberately skewed
    rank step rates; returns once every rank's ``x / p`` is within ``tol``
    of the true mean, or when ``timeout_s`` expires.

    Args:
      topology: directed graph; rank r deposits to its out-neighbours.
      x0: ``(n_ranks, n_elems)`` initial values; the target is their mean.
      skew: per-rank extra sleep (seconds) per step; the default makes the
        slowest rank ~5x the fastest.
      tol / timeout_s: the convergence gate.
      resilience: peer-fault tolerance.  Ranks beat a shared
        :class:`~bluefog_tpu_torch.runtime.resilience.HealthBoard` each
        round; a rank that stops beating (a killed or stalled thread) is
        declared DEAD after ``dead_after_s`` of silence and the survivors
        renormalise their mixing weights over the surviving set
        (:func:`~bluefog_tpu_torch.topology.graphs.heal`); push-sum's
        weight channel keeps the surviving average unbiased.  A rank that
        beats again is REJOINED and re-admitted at the next round
        boundary.  Convergence is then judged by survivor consensus (the
        mass-weighted mean of what survived, not the mean of ``x0``).
        ``dead_after_s`` must exceed the slowest rank's per-step sleep.
      step_hook: ``(rank, step) -> None``, called at the top of every
        rank step: it may sleep (a stall) or raise :class:`RankKilled`
        (a death).  A chaos spec's ``rank<N>:die`` and ``rank<N>:stall``
        rules act at the same point.
      native: ``False`` runs on the Python twin of the window table.

    A rank's step, with no barrier anywhere: consume its landing slots,
    folding the received (x, p) mass in; keep ``1/(out_deg+1)`` of its
    mass and deposit the same fraction into each out-neighbour's window
    (accumulate); publish its estimate and sleep ``skew[r]``.  A monitor
    raises the stop flag on convergence; the ranks then drain the mass
    still in flight, so ``sum(p) == n`` holds exactly (with deaths,
    ``total_mass + died_mass == n``).
    """
    n = topology.size
    x0 = np.asarray(x0, np.float64)
    if x0.shape[0] != n:
        raise ValueError(f"x0 leading dim {x0.shape[0]} != topology size {n}")
    n_elems = int(np.prod(x0.shape[1:], dtype=np.int64)) if x0.ndim > 1 else 1
    x0 = x0.reshape(n, n_elems)
    true_mean = x0.mean(axis=0)

    if skew is None:
        skew = [poll_interval_s * (1.0 + 4.0 * r / max(n - 1, 1))
                for r in range(n)]

    in_nbrs = [list(topology.in_neighbors(r)) for r in range(n)]
    out_nbrs = [list(topology.out_neighbors(r)) for r in range(n)]
    # slot index of src in dst's window
    slot_of = [{src: k for k, src in enumerate(in_nbrs[r])} for r in range(n)]

    wins = _create_windows(
        name, [len(in_nbrs[r]) for r in range(n)], n_elems + 1,
        native=native)

    stop = threading.Event()
    steps = [0] * n
    estimates = x0.copy()
    est_mu = _lc.lock("runtime.async_windows.run_async_pushsum.est_mu")
    errors: List[BaseException] = []
    board = (_res.HealthBoard(n, suspect_after_s=resilience.suspect_after_s,
                              dead_after_s=resilience.dead_after_s)
             if resilience is not None else None)
    died = [False] * n
    died_mass = [0.0] * n

    def rank_loop(r: int):
        x = x0[r].copy()
        p = 1.0
        try:
            my_out = list(out_nbrs[r])
            frac = 1.0 / (len(my_out) + 1)
            known_dead: set = set()
            while not stop.is_set():
                if step_hook is not None:
                    step_hook(r, steps[r])
                _chaos.check_step(r, steps[r])
                if board is not None:
                    board.beat(r)
                    dead_now = board.dead_ranks() - {r}
                    if dead_now != known_dead:
                        # round boundary: re-admit any REJOINED rank (it
                        # left the dead set by beating again) and heal
                        # the mixing weights over the current survivors
                        for j in known_dead - dead_now:
                            board.admit(j)
                        known_dead = set(dead_now)
                        healed = _heal(topology, known_dead)
                        my_out = list(healed.out_neighbors(r))
                        frac = 1.0 / (len(my_out) + 1)
                # 1. consume whatever landed (possibly nothing; slots of
                # dead in-neighbours still drain their final in-flight
                # mass, which is what keeps the audit exact)
                for k in range(len(in_nbrs[r])):
                    buf, fresh = wins[r].read(k, consume=True)
                    if fresh > 0:
                        x += buf[:-1]
                        p += buf[-1]
                # 2. split mass outward: receivers need not be listening
                payload = np.concatenate([x * frac, [p * frac]])
                for j in my_out:
                    wins[j].deposit(slot_of[j][r], payload, accumulate=True)
                x *= frac
                p *= frac
                # 3. publish the estimate, then rank-dependent "compute"
                with est_mu:
                    estimates[r] = x / p
                steps[r] += 1
                time.sleep(skew[r])
            # drain: fold in the mass still in flight so sum(p) == n
            for k in range(len(in_nbrs[r])):
                buf, fresh = wins[r].read(k, consume=True)
                if fresh > 0:
                    x += buf[:-1]
                    p += buf[-1]
            with est_mu:
                estimates[r] = x / p
            wins[r].set_self(np.concatenate([x, [p]]))
        except (RankKilled, _chaos.ChaosKill):
            # a killed rank: no drain, no publish; being in-process, it
            # leaves a last will of the mass it took down, which makes
            # the survivors' audit exact (total_mass + died_mass == n)
            died[r] = True
            died_mass[r] = p
        except BaseException as e:  # surfaced by the caller
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=rank_loop, args=(r,), daemon=True)
               for r in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()

    converged = False
    while time.perf_counter() - t0 < timeout_s:
        time.sleep(poll_interval_s * 5)
        if errors:
            break
        alive = [r for r in range(n) if not died[r]]
        if not alive:
            break  # every rank was killed; the report says so
        with est_mu:
            if board is None:
                err = float(np.abs(estimates - true_mean).max())
            else:
                # with deaths the surviving average is the mass-weighted
                # mean of what survived: judge survivor consensus
                zs = estimates[alive]
                err = float(np.abs(zs - zs.mean(axis=0)).max())
        # every live rank must also have taken a few steps (no vacuous
        # pass)
        if err < tol and min(steps[r] for r in alive) >= 3:
            converged = True
            break
    stop.set()
    # a rank may be mid-sleep: give every thread time to wake, drain and
    # publish before the audit (freeing windows under a live thread would
    # corrupt the audit and fail its next deposit)
    join_budget = max(skew) * 2 + 5.0
    for t in threads:
        t.join(timeout=join_budget)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(
            "async push-sum rank threads failed to stop within "
            f"{join_budget:.1f}s; aborting without freeing windows")
    wall = time.perf_counter() - t0

    if errors:
        for w in wins:
            w.free()
        raise errors[0]

    # mass invariant: self mass plus anything deposited after a rank's
    # final drain (the threads are joined, so the reads race with
    # nothing).  A dead rank's window still counts: its landing slots hold
    # the mass that was in flight toward the corpse.
    total_mass = 0.0
    for r in range(n):
        if not died[r]:
            total_mass += float(wins[r].read_self()[-1])
        total_mass += _landed_mass(wins[r], range(len(in_nbrs[r])))
    alive = [r for r in range(n) if not died[r]]
    with est_mu:
        if not alive:
            final_err = float("inf")  # no survivors, no consensus claim
        elif board is None or not any(died):
            final_err = float(np.abs(estimates - true_mean).max())
        else:
            zs = estimates[alive]
            final_err = float(np.abs(zs - zs.mean(axis=0)).max())
    report = PushSumReport(
        converged=converged and final_err < 10 * tol,
        wall_time_s=wall,
        steps_per_rank=list(steps),
        estimates=estimates.copy(),
        true_mean=true_mean,
        max_abs_err=final_err,
        total_mass=total_mass,
        dead_ranks=[r for r in range(n) if died[r]],
        died_mass=float(sum(died_mass)),
        health_transitions=(
            {r: board.transitions(r) for r in range(n)}
            if board is not None else None),
    )
    for w in wins:
        w.free()
    return report


# ---------------------------------------------------------------------------
# Asynchronous decentralized training (subgradient-push over the windows)
# ---------------------------------------------------------------------------


@dataclass
class DSGDReport:
    """Outcome of an asynchronous decentralized SGD run."""

    wall_time_s: float
    steps_per_rank: List[int]
    losses: List[List[float]]        # per rank, per local step
    final_params: list               # per rank, de-biased z = x/p trees
    total_mass: float                # sum of p over ranks (+ in flight) == n
    consensus_gap: float             # max over ranks of max|z_r - z_mean|
    # per rank, seconds of each part of its steps (the runner's own
    # clock): consume, unpack, loss_and_grad, pack, deposit — the host
    # breakdown of a rank step — and, with overlap, the harvester's
    # seconds hidden under them.  The process runner fills its own
    # rank's entry only (rank 0's report).
    phase_s: List[Dict[str, float]] = field(default_factory=list)
    # fault-tolerant runs only:
    dead_ranks: List[int] = field(default_factory=list)
    # thread mode: mass the killed threads carried to the grave (exact
    # audit: total_mass + died_mass == n, or == baseline_mass)
    died_mass: float = 0.0
    # process mode: the surviving set's mass measured at the post-heal
    # rendezvous (exact audit: total_mass == baseline_mass); elastic runs
    # re-measure it at every admission.  Thread mode, elastic: every unit
    # of mass that ever entered (initial members + one per admission).
    baseline_mass: Optional[float] = None
    # thread mode: per-rank health transitions [(t, from, to)]
    health_transitions: Optional[Dict[int, list]] = None
    # elastic membership: ranks that completed a graceful drain (their
    # mass handed off, conserved) and ranks admitted by a join
    left_ranks: List[int] = field(default_factory=list)
    joined_ranks: List[int] = field(default_factory=list)
    # process mode over tcp: bytes the reporting rank's deposit streams
    # put on the wire; and per rank (the survivors) its streams'
    # exactly-once bookkeeping: reconnects, batches re-sent and batches
    # retired by an attach reply (applied, their ack lost), the replayed
    # duplicates its own server consumed without an apply ("deduped"),
    # each peer's ack EWMA in seconds ("ack_ewma_s") and, over traced
    # streams, each peer's {net, queue, apply} EWMA ("phase_s")
    wire_bytes: int = 0
    stream_stats: Dict[int, dict] = field(default_factory=dict)
    # control= runs: the highest-version plan a reporting rank's
    # controller made, and its number of plan changes
    control_plan: Optional[object] = None
    plan_changes: int = 0


class DoubleBuffer:
    """Compute/gossip overlap for the DSGD runners: a background harvester
    consumes landed neighbour deposits from this rank's own landing window
    while the round's gradient compute runs, staging them per slot; the
    staged round-(k-1) mass is applied only at the next round boundary
    (:meth:`apply_staged`).

    Invariants:

    - **Mass moves exactly once.**  A harvested read is the window's
      consume-exactly-once take; the taken (x, p) sits in the per-slot
      staging buffer until a boundary applies it, or :meth:`close` hands
      it back.
    - **Fold order is the serial order.**  Staging accumulates per slot in
      deposit order and :meth:`apply_staged` returns entries in slot
      order: the floating-point sequence of the serial fold, so for the
      same landed deposits the result is byte-identical to serial.
    - **The wire is quiesced at every boundary.**  ``apply_staged`` and
      ``pause`` disarm the harvester and wait for its sweep in flight.

    ``apply_staged`` also returns the seconds the harvester spent taking
    and staging (its sleeps excluded): the share of gossip-IN work hidden
    under compute.

    Unlike the JAX package's, a sweep reads only the slots where deposits
    landed (:meth:`AsyncWindow.fresh`), and the staging buffers are the
    harvester's own, allocated once: the entries :meth:`apply_staged`
    returns are folded before :meth:`begin` re-arms it.
    """

    def __init__(self, win, slots: Sequence[int], n_elems: int, *,
                 poll_s: float = 0.0005):
        self._win = win
        self._slots = [int(s) for s in slots]
        self._n = int(n_elems)
        self._poll_s = float(poll_s)
        self._mu = _lc.lock("runtime.async_windows.DoubleBuffer._mu")
        # _sweep_mu serialises sweeps against pause(): pause clears the arm
        # flag, then takes it, so on return no sweep runs and none starts
        self._sweep_mu = _lc.lock(
            "runtime.async_windows.DoubleBuffer._sweep_mu")
        self._stage: Dict[int, np.ndarray] = {}   # per slot, kept
        self._fresh: Dict[int, int] = {}          # slots holding mass
        self._scratch: Optional[np.ndarray] = None
        self._busy_s = 0.0
        self._armed = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._harvest_loop, daemon=True,
            name=f"bf-harvest-{getattr(win, 'name', 'win')}")
        self._thread.start()

    def _buffer(self, k: int) -> np.ndarray:
        buf = self._stage.get(k)
        if buf is None:
            buf = self._stage[k] = np.empty(self._n, self._win.dtype)
        return buf

    def _sweep(self, *, count_busy: bool) -> None:
        t0 = time.perf_counter() if count_busy else 0.0
        for k in self._slots:
            if self._win.fresh(k) == 0:
                continue
            with self._mu:
                staged = k in self._fresh
            if not staged:
                _, fresh = self._win.read(k, consume=True,
                                          out=self._buffer(k))
            else:
                if self._scratch is None:
                    self._scratch = np.empty(self._n, self._win.dtype)
                _, fresh = self._win.read(k, consume=True, out=self._scratch)
            if fresh > 0:
                with self._mu:
                    if staged:
                        self._stage[k] += self._scratch
                    self._fresh[k] = self._fresh.get(k, 0) + int(fresh)
        if count_busy:
            with self._mu:
                self._busy_s += time.perf_counter() - t0

    def _harvest_loop(self) -> None:
        while True:
            self._armed.wait()
            if self._stopped:
                return
            with self._sweep_mu:
                # re-check under the lock: a pause() between the wait and
                # here must win (its return promises quiescence)
                if self._armed.is_set() and not self._stopped:
                    try:
                        self._sweep(count_busy=True)
                    except RuntimeError:
                        # the window vanished (an abnormal teardown): go
                        # idle; the boundary's inline sweep raises for real
                        self._armed.clear()
            if self._poll_s > 0:
                time.sleep(self._poll_s)

    def begin(self) -> None:
        """Arm one harvest window, until the next boundary."""
        self._armed.set()

    def pause(self) -> None:
        """Disarm and wait for the sweep in flight; staged mass is kept."""
        self._armed.clear()
        with self._sweep_mu:
            pass

    def apply_staged(self) -> Tuple[List[Tuple[int, np.ndarray, int]],
                                    float]:
        """Round-boundary apply: quiesce the harvester, take one final
        inline sweep (a round folds at least what the serial path would),
        and return ``([(slot, payload, fresh), ...] in slot order,
        hidden harvest seconds)``.  The caller folds the entries in that
        order and re-arms with :meth:`begin`."""
        self.pause()
        self._sweep(count_busy=False)
        with self._mu:
            entries = self._take()
            busy, self._busy_s = self._busy_s, 0.0
        return entries, busy

    def _take(self) -> List[Tuple[int, np.ndarray, int]]:
        """The staged entries in slot order, emptying the stage (the caller
        holds ``_mu``)."""
        return [(k, self._stage[k], self._fresh.pop(k))
                for k in self._slots if k in self._fresh]

    def staged_mass(self) -> float:
        """Push-sum weight staged and not applied yet.  Call after
        :meth:`pause`: a quiesce-rendezvous adds it to the local mass, so
        taken-but-unapplied mass cannot hide from the audit."""
        with self._mu:
            return float(sum(float(self._stage[k][-1])
                             for k in self._fresh))

    def close(self) -> List[Tuple[int, np.ndarray, int]]:
        """Stop the harvester and hand back whatever is staged (slot
        order), so taken mass is never dropped.  Idempotent."""
        self._stopped = True
        self._armed.set()  # release a parked wait
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        with self._mu:
            return self._take()


def _fold(entries, x, p, on_entry=None):
    """Fold staged ``(slot, payload, fresh)`` entries into ``(x, p)`` in
    their order; returns the new ``p``.  ``on_entry(slot, payload)`` sees
    each entry before it is folded (the control plane's observations)."""
    for k, buf, fresh in entries:
        if fresh > 0:
            if on_entry is not None:
                on_entry(k, buf)
            x += buf[:-1]
            p += buf[-1]
    return p


def _take_and_fold(win, slots, x, p, buf, on_entry=None):
    """Serial gossip-IN: read each slot where deposits landed into ``buf``
    (consumed exactly once) and fold it into ``(x, p)``, in slot order;
    returns the new ``p``.  ``buf`` is scratch of the window's size;
    ``on_entry`` as in :func:`_fold`."""
    for k in slots:
        if win.fresh(k) == 0:
            continue
        _, fresh = win.read(k, consume=True, out=buf)
        if fresh > 0:
            if on_entry is not None:
                on_entry(k, buf)
            x += buf[:-1]
            p += buf[-1]
    return p


class _Disagreement:
    """The local disagreement of one gossip-IN, the control plane's
    consensus signal: the largest ``||z_j - z||`` over the de-biased
    neighbour mass ``z_j = x_j / p_j`` folded in, against this rank's
    ``z = x / p`` before the fold.  Where a caller keeps freshness clocks
    (``fresh_at``, keyed by source rank), each entry also stamps its
    source's (``source(slot)``) with the fold's time."""

    def __init__(self, x, p, fresh_at=None, source=None):
        self._z = x / p
        self._fresh_at = fresh_at
        self._source = source
        self._now = time.perf_counter()
        self.value: Optional[float] = None

    def __call__(self, k, buf) -> None:
        if buf[-1] > 0:
            dj = float(np.linalg.norm(buf[:-1] / buf[-1] - self._z))
            self.value = dj if self.value is None else max(self.value, dj)
        if self._fresh_at is not None:
            self._fresh_at[self._source(k)] = self._now


def _landed_mass(win, slots) -> float:
    """The push-sum weight landed in ``slots`` and not yet consumed (the
    audit's read: nothing is consumed)."""
    mass, buf = 0.0, None
    for k in slots:
        if win.fresh(k) > 0:
            if buf is None:
                buf = np.empty(win.n_elems, win.dtype)
            mass += float(win.read(k, consume=False, out=buf)[0][-1])
    return mass


def _stream_context(packer: TreePacker):
    """Each rank thread runs on its own CUDA stream when the parameters
    live on the card: PyTorch's current stream is per thread, and on the
    one default stream the ranks' kernels would serialise behind each
    other.  On the CPU, nothing."""
    if packer.device is None:
        return contextlib.nullcontext()
    import torch

    return torch.cuda.stream(torch.cuda.Stream(packer.device))


def _emit_round(trec, t0_wall: float, t0_perf: float, step: int,
                ov: Optional[float]) -> None:
    """The rank body's ``round`` span, emitted when the round ends (its
    ``gossip``, ``compute`` and ``publish`` spans nest in it by time);
    ``overlap`` is the share of the overlapped fold hidden under
    compute."""
    trec.emit("round", "dsgd", t0=t0_wall,
              dur=time.perf_counter() - t0_perf, round_=step, step=step,
              **({} if ov is None else {"overlap": round(ov, 4)}))


def _check_dsgd_args(*, snapshot_every=0, fleet=None) -> None:
    if snapshot_every < 0:
        raise ValueError(f"snapshot_every must be >= 0, got {snapshot_every}")
    if fleet is not None:
        raise _not_ported("fleet=", "11", "the fleet health plane")


def _arm_profiler(profile: Optional[str], rank: int) -> bool:
    """Arm the sampling profiler for a run: with ``profile=`` a sampler
    writing ``profile-rank<rank>.jsonl`` into that directory, owned by
    the caller (True) unless ``BLUEFOG_TPU_PROFILE`` already armed one.
    Without it, the env-armed profiler (if any) takes this rank, and its
    exit hook owns the tail flush."""
    if profile is None:
        _profiling.set_rank(rank)
        return False
    if _profiling.get() is not None:
        return False
    _profiling.configure(profile, rank=rank)
    return True


def run_async_dsgd(
    topology: Topology,
    params0,
    loss_and_grad,
    *,
    lr: float = 0.05,
    duration_s: float = 5.0,
    skew: Optional[Sequence[float]] = None,
    name: str = "async_dsgd",
    poll_interval_s: float = 0.0,
    resilience: Optional[_res.ResilienceConfig] = None,
    join_at_s: Optional[Dict[int, Sequence[float]]] = None,
    leave_at_s: Optional[Dict[int, float]] = None,
    snapshot_every: int = 0,
    control=None,
    stop_after_steps: Optional[int] = None,
    fleet=None,
    profile=None,
    overlap: bool = False,
    step_hook: Optional[Callable[[int, int], None]] = None,
    native: Optional[bool] = None,
) -> DSGDReport:
    """Asynchronous decentralized SGD (subgradient-push, Nedić and
    Olshevsky) over the passive-target windows, with rank threads: the
    execution model of the reference's ``DistributedWinPutOptimizer``
    (parameters pushed one-sidedly each step and merged by the receiver
    whenever it steps), with no barrier anywhere and rank-dependent step
    rates.

    A rank thread's step:
      1. consume landed ``(x, p)`` mass from its in-neighbour slots;
      2. de-bias ``z = x / p``, the rank's current model;
      3. ``loss, grads = loss_and_grad(rank, step, z_tree)`` on real model
         parameters (trees of tensors on the card, through
         :class:`TreePacker`);
      4. ``x <- x - lr * p * grad`` (so the de-biased iterate takes the
         plain step ``z' = z - lr * grad``);
      5. keep ``1/(out_deg+1)`` of ``(x, p)`` and deposit the same fraction
         into each out-neighbour's window (accumulate).

    Mass is conserved exactly (``sum(p) == n`` under any interleaving).
    Ranks stepping at different rates weight the objective by their rates:
    with constant steps the stationary point is the rate-weighted optimum
    (inherent to asynchronous SGD, as in the reference's async mode).

    Args:
      topology: directed graph over the rank threads (with ``join_at_s``
        or ``leave_at_s``, the job's capacity).
      params0: initial parameters (a tree; the same start on every rank).
        When its leaves are CUDA tensors, each rank thread runs on its own
        CUDA stream.
      loss_and_grad: ``(rank, step, params_tree) -> (loss, grad_tree)``,
        called concurrently from the rank threads.
      lr: SGD step on the de-biased iterate.
      duration_s: wall-clock budget (the ranks then drain the mass in
        flight, so the audit is exact).
      skew: per-rank extra sleep per step; the default makes the slowest
        rank ~5x the fastest.
      resilience: peer-fault tolerance (see :func:`run_async_pushsum`):
        ranks beat a shared health board each round, a silent rank is
        declared DEAD after ``dead_after_s`` and healed out of the mixing
        weights; a rank that beats again is re-admitted at the next round
        boundary.  A killed thread (:class:`RankKilled`) leaves a last
        will of the mass it carried: ``total_mass + died_mass == n``.
      join_at_s / leave_at_s: elastic membership.  ``join_at_s`` maps a
        rank to the offsets (seconds from the start) at which it attaches
        to the running job: the rank starts absent, then at each offset
        warm-starts from a live member's published ``(x, p)`` (its
        window's ``read_self``, no checkpoint anywhere), enters with a
        fresh ``p = 1`` and is admitted through the JOINING state at a
        round boundary.  ``leave_at_s`` maps a rank to the offset of its
        graceful drain: it hands its whole ``(x, p)`` to its live
        out-neighbours in drain deposits (a leaver's mass is conserved,
        never written off like a corpse's) and stops; a later join offset
        re-admits it.  Live ranks re-plan the mixing graph over the
        current member set at round boundaries
        (:func:`~bluefog_tpu_torch.topology.graphs.replan`, deterministic
        in the member list), and the audit is exact over the churn:
        ``total_mass + died_mass == baseline_mass``.  Chaos churn adds to
        both: a ``rank<N>:join:after_s=T`` rule is a join offset, and a
        ``rank<N>:leave:at_step=K`` rule drains the rank at step K.
      control: the self-tuning communication control plane
        (:class:`~bluefog_tpu_torch.control.ControlConfig`).  Each rank
        thread runs a :class:`~bluefog_tpu_torch.control.CommController`
        fed with the seconds since each in-neighbour's last fresh deposit
        (the thread analog of the wire's ack EWMA), the local
        disagreement and a :class:`~bluefog_tpu_torch.metrics.health.
        MixingTracker`'s excess; every ``evidence_every`` steps, at a
        round boundary, it publishes its evidence to an in-process
        :class:`~bluefog_tpu_torch.control.EvidenceBoard`, decides over
        the board (a killed rank's record is left out) and, when the plan
        changed, installs the penalized mixing graph and the gossip
        cadence.  Landing slots are then one a capacity rank (slot index
        == source rank), stable under any replan.  The audit stays exact
        through every plan change; the report carries the highest-version
        plan (``control_plan``) and ``plan_changes``.
      stop_after_steps: end the run (all ranks drain) as soon as any rank
        has taken this many steps.
      overlap: compute/gossip overlap through :class:`DoubleBuffer`: a
        harvester per rank consumes landed deposits while the gradient
        runs, and the staged mixing is applied at the next round boundary
        in slot order (the serial fold order).
      step_hook: ``(rank, step) -> None`` at the top of every rank step:
        it may sleep (a stall) or raise :class:`RankKilled` (a death).
        Chaos rules (``rank<N>:die``, ``:stall``, ``:leave``) act at the
        same point.
      native: ``False`` runs on the Python twin of the window table.
      snapshot_every: when > 0, every rank publishes a round-stamped
        snapshot, ``{"x": x, "p": [p], "round": [step]}`` (z = x / p is
        the rank's model), into the process-global serving table every
        Nth step under the group ``f"{name}:{r}"``; any ``WindowServer``
        in this process serves it (:mod:`bluefog_tpu_torch.serving`).  The
        publish is atomic (double-buffered, swapped under one lock), so
        readers never see a torn ``(x, p)`` pair, and it only reads: the
        mass audit is unchanged.  The groups are dropped at the end.
      profile: directory for the sampling profiler
        (:mod:`bluefog_tpu_torch.profiling`): arms a process-wide sampler
        for the run and writes phase-attributed folded stacks to
        ``profile-rank0.jsonl`` there (the rank threads share one
        process, so one file holds every thread's samples).  A profiler
        that ``BLUEFOG_TPU_PROFILE`` already armed is left alone: the
        runner only stops what it started.
      fleet (ROADMAP item 11): not ported yet; raises
        ``NotImplementedError``.
    """
    _check_dsgd_args(snapshot_every=snapshot_every, fleet=fleet)
    n = topology.size
    packer = TreePacker(params0, np.float64)
    d = packer.size

    if skew is None:
        base = 0.001
        skew = [base * (1.0 + 4.0 * r / max(n - 1, 1)) for r in range(n)]

    in_nbrs = [list(topology.in_neighbors(r)) for r in range(n)]
    joins: Dict[int, List[float]] = {}
    for r, ts in (join_at_s or {}).items():
        seq = [ts] if isinstance(ts, (int, float)) else list(ts)
        joins[int(r)] = sorted(float(t) for t in seq)
    # chaos churn: a rank<N>:join:after_s rule adds a join offset, and a
    # rank<N>:leave:at_step rule raises ChaosLeave inside the loop
    for r in range(n):
        ct = _chaos.join_times(r)
        if ct:
            joins.setdefault(r, []).extend(ct)
            joins[r].sort()
    leaves = {int(r): float(t) for r, t in (leave_at_s or {}).items()}
    inj = _chaos.get()
    elastic = bool(joins or leaves) or (
        inj is not None and any(ru.fault in ("leave", "join")
                                for ru in inj.rules))
    members0 = frozenset(range(n)) - frozenset(joins)
    if elastic and not members0:
        raise ValueError("every rank has a join schedule; at least one "
                         "initial member must seed the warm-start chain")

    # slot scheme: elastic and control-plane runs take one landing slot
    # per capacity rank (slot index == source rank), stable under
    # membership change and under controller replans (a penalized graph
    # has edges the original topology had no slot for); fixed fleets keep
    # the dense in-degree sizing (~log2 n slots a rank instead of n, a
    # real difference when d is model-sized)
    cap_slots = elastic or control is not None
    if cap_slots:
        wins = _create_windows(name, [n] * n, d + 1, native=native)
        slot_of = None
    else:
        wins = _create_windows(
            name, [max(len(in_nbrs[r]), 1) for r in range(n)], d + 1,
            native=native)
        slot_of = [{src: k for k, src in enumerate(in_nbrs[r])}
                   for r in range(n)]

    stop = threading.Event()
    steps = [0] * n
    losses: List[List[float]] = [[] for _ in range(n)]
    finals: list = [None] * n
    phase_keys = ("consume", "unpack", "loss_and_grad", "pack", "deposit",
                  "harvest") + (("publish",) if snapshot_every else ())
    phases: List[Dict[str, float]] = [
        dict.fromkeys(phase_keys, 0.0) for _ in range(n)]
    errors: List[BaseException] = []
    x0 = packer.pack(params0)
    if packer.device is not None:
        # the rank threads run on their own streams: what the caller made
        # on the default stream (parameters, data) must be complete
        import torch

        torch.cuda.synchronize(packer.device)
    board = (_res.HealthBoard(
        n,
        suspect_after_s=(resilience.suspect_after_s
                         if resilience is not None else 0.5),
        dead_after_s=(resilience.dead_after_s
                      if resilience is not None else 2.0),
        members=members0 if elastic else None)
        if (resilience is not None or elastic or control is not None)
        else None)
    died = [False] * n
    died_mass = [0.0] * n
    # the control plane: the board every rank's controller publishes to
    # and decides from, and the per-rank outcomes the report carries
    ctl_board = _EvidenceBoard() if control is not None else None
    final_plans: list = [None] * n
    ctl_changes = [0] * n

    # the shared membership truth; each rank re-derives its plan from it
    # at round boundaries, so every loop converges on the same replan
    # with no coordination beyond this set
    mem_mu = _lc.lock("runtime.async_windows.run_async_dsgd.mem_mu")
    members = set(members0)
    left_final: set = set()
    ever_joined: set = set()
    joined_mass = [0.0]
    plan_cache: Dict[frozenset, Topology] = {}

    def _plan(active: frozenset) -> Topology:
        # the gauge tracks the current set even when the plan is a cache
        # hit (a flapping member returns to a set already seen)
        _mt.set("bf_members", float(len(active)))
        with mem_mu:
            cached = plan_cache.get(active)
        if cached is not None:
            return cached
        t0p = time.perf_counter()
        if elastic:
            plan = _replan(topology, active)
        else:
            plan = _heal(topology, frozenset(range(n)) - active)
        _mt.observe("bf_replan_seconds", time.perf_counter() - t0p)
        with mem_mu:
            plan_cache[active] = plan
        return plan

    t_run0 = time.perf_counter()

    def rank_loop(r: int):
        p = 1.0
        # model-sized scratch, allocated once per rank
        gvec = np.empty(d, np.float64)
        zbuf = np.empty(d, np.float64)
        payload = np.empty(d + 1, np.float64)
        rec = _bb.get()  # flight recorder (None when off)
        my_joins = list(joins.get(r, []))
        is_member = r in members0
        leave_deadline = leaves.get(r)
        my_slots = ([k for k in range(n) if k != r] if cap_slots
                    else list(range(len(in_nbrs[r]))))
        ph = phases[r]
        db = (DoubleBuffer(wins[r], my_slots, d + 1) if overlap else None)

        # ------------------------------------------ control plane (opt-in)
        ctl = (_CommController(r, n, config=control)
               if control is not None else None)
        tracker: Optional[_MixingTracker] = None
        tracker_members: Optional[frozenset] = None
        my_in: List[int] = list(in_nbrs[r])
        gossip_every = 1
        # per-peer deposit-staleness clocks, keyed by source rank: the
        # thread-mode lag signal (seconds since the peer's last fresh
        # deposit, the in-process analog of the wire's ack EWMA)
        last_fresh: Dict[int, float] = {}

        def consume(x, p, staged=None, observe=False):
            watch = None
            if observe and ctl is not None:
                watch = _Disagreement(
                    x, p, last_fresh,
                    (lambda k: k) if cap_slots else in_nbrs[r].__getitem__)
            if staged is None:
                # serial path: take the slots where mass landed, in slot
                # order, into the rank's read buffer
                p = _take_and_fold(wins[r], my_slots, x, p, payload, watch)
            else:
                # the fold of what the harvester staged under compute, in
                # slot order too: the same operations as the serial fold
                p = _fold(staged, x, p, watch)
            if watch is not None and watch.value is not None:
                ctl.note_disagreement(watch.value)
            return p

        def harvest_evidence_at_round_boundary():
            """Per-peer observations for this evidence window.  Lag
            evidence covers only the current in-neighbours (a peer whose
            edges the plan dropped stops accumulating staleness against
            ranks it no longer feeds), and observations of ranks outside
            that surface are forgotten, so a frozen last look at a corpse
            or a dropped peer is not republished."""
            ctl.retain_peers(k for k in my_in if k != r)
            now = time.perf_counter()
            states = board.states() if board is not None else {}
            for k in my_in:
                if k == r:
                    continue
                ctl.note_peer(k, lag_s=now - last_fresh.setdefault(k, now),
                              state=states.get(k))

        def actuate_plan_at_round_boundary(active):
            """Install the controller's current plan at this round
            boundary (in-process deposits are synchronous, so nothing of
            this rank's is in flight) and rebase the mixing tracker on the
            topology now in effect; returns that topology."""
            nonlocal tracker, gossip_every, tracker_members
            plan_topo = ctl.apply_plan(topology=topology, members=active)
            gossip_every = ctl.plan.gossip_every
            # the feed-window exponent follows the cadence in effect
            rpu = max(1, round(control.evidence_every / gossip_every))
            live = frozenset(active)
            if tracker is None:
                tracker = _MixingTracker(plan_topo, rounds_per_update=rpu)
            else:
                if tracker_members is not None and live != tracker_members:
                    # a membership boundary: the previous distance was
                    # measured over another member set
                    tracker.reset_measurement()
                tracker.rebase(plan_topo, rounds_per_update=rpu)
            tracker_members = live
            ctl_changes[r] = ctl.plan.version
            return plan_topo

        try:
            with _stream_context(packer):
                x = x0.copy()
                while not stop.is_set():
                    if not is_member:
                        # ---------------------------------- join the job
                        if not my_joins:
                            return  # a reserved slot, never scheduled
                        t_join = my_joins.pop(0)
                        while (time.perf_counter() - t_run0 < t_join
                               and not stop.is_set()):
                            time.sleep(0.002)
                        if stop.is_set():
                            return
                        # warm start: a live member's published (x, p)
                        # through its window, no checkpoint read.  The
                        # pair is published under the window's self
                        # mutex, so the joiner's first state is
                        # round-consistent.
                        if board is not None:
                            board.mark_joining(r)
                        t_warm = time.perf_counter()
                        z = None
                        deadline = time.perf_counter() + max(duration_s,
                                                             5.0)
                        while (z is None and not stop.is_set()
                               and time.perf_counter() < deadline):
                            with mem_mu:
                                cand = sorted(members - {r})
                            for nb in cand:
                                s = wins[nb].read_self()
                                if s[-1] > 0.0:
                                    z = s[:-1] / s[-1]
                                    break
                            if z is None:
                                time.sleep(0.002)
                        if z is None:
                            z = x0  # no member published yet: cold start
                        x = np.array(z, np.float64)
                        p = 1.0  # fresh push-sum weight: mass enters here
                        with mem_mu:
                            members.add(r)
                            joined_mass[0] += 1.0
                            ever_joined.add(r)
                            left_final.discard(r)
                        if board is not None:
                            board.admit(r)  # its own first round boundary
                        is_member = True
                        if overlap and db is None:
                            # a member re-joining after a graceful leave
                            # closed its harvester: a fresh one
                            db = DoubleBuffer(wins[r], my_slots, d + 1)
                        warm = time.perf_counter() - t_warm
                        _mt.observe("bf_join_warmstart_seconds", warm)
                        _bb.record("peer_join", peer=f"rank{r}", rank=r,
                                   warmstart_s=round(warm, 6))
                        # publish at once: a second joiner may warm from
                        # this rank before its first full round
                        wins[r].set_self(np.concatenate([x, [p]]))

                    # ---------------------------------------- gossip loop
                    my_out: List[int] = []
                    frac = 1.0
                    known_active: Optional[frozenset] = None
                    want_leave = False
                    while not stop.is_set():
                        if step_hook is not None:
                            step_hook(r, steps[r])
                        try:
                            _chaos.check_step(r, steps[r])
                        except _chaos.ChaosLeave:
                            want_leave = True
                            break
                        if (leave_deadline is not None
                                and time.perf_counter() - t_run0
                                >= leave_deadline):
                            leave_deadline = None
                            want_leave = True
                            break
                        if board is not None:
                            board.beat(r)
                        with mem_mu:
                            active = frozenset(members)
                        if resilience is not None:
                            active = active - (board.dead_ranks() - {r})
                        if active != known_active:
                            # round boundary: re-admit ranks that came
                            # back (REJOINED) or announced (JOINING),
                            # then re-plan over the current member set
                            if known_active is not None \
                                    and board is not None:
                                for j in active - known_active:
                                    if board.state(j) in (_res.REJOINED,
                                                          _res.JOINING):
                                        board.admit(j)
                            known_active = active
                            plan = (actuate_plan_at_round_boundary(active)
                                    if ctl is not None else _plan(active))
                            my_out = list(plan.out_neighbors(r))
                            my_in = list(plan.in_neighbors(r))
                            frac = 1.0 / (len(my_out) + 1)
                        elif (ctl is not None and steps[r] > 0
                              and steps[r] % control.evidence_every == 0):
                            # control round boundary: fold this window's
                            # mixing measurement in, publish evidence,
                            # decide over the board, and actuate when the
                            # plan version advanced
                            harvest_evidence_at_round_boundary()
                            d_now = ctl.disagreement
                            if tracker is not None and d_now is not None:
                                measured = tracker.update(d_now)
                                excess = None
                                if (measured is not None
                                        and tracker.predicted is not None
                                        and measured < 1.0):
                                    # interpretable only while gossip
                                    # contracts; at the SGD equilibrium
                                    # the growth band governs instead
                                    excess = measured - tracker.predicted
                                ctl.note_mixing_excess(excess)
                            ctl_board.publish(ctl.evidence(steps[r]))
                            # a corpse's frozen record must not keep
                            # voting: the thread-mode truth of a death is
                            # its last will
                            evs = [ev for ev in ctl_board.snapshot()
                                   if not died[ev.rank]]
                            new_plan = ctl.decide(steps[r], evs)
                            if new_plan.version != ctl_changes[r]:
                                plan = actuate_plan_at_round_boundary(
                                    active)
                                my_out = list(plan.out_neighbors(r))
                                my_in = list(plan.in_neighbors(r))
                                frac = 1.0 / (len(my_out) + 1)
                        # per-round recorder markers: a begin without
                        # its end in a dump names the round the loop
                        # wedged in
                        if rec is not None:
                            rec.begin("collective",
                                      key=("async_dsgd", r, steps[r]),
                                      op="async_dsgd_round",
                                      cid="async_dsgd_round",
                                      step=steps[r], rank=r, peers=my_out)
                        t0 = time.perf_counter()
                        if db is not None:
                            # round boundary: fold what the harvester
                            # staged under the last compute, re-arm it;
                            # the hidden share is bf_overlap_fraction
                            staged, hidden = db.apply_staged()
                            p = consume(x, p, staged, observe=True)
                            tot = hidden + (time.perf_counter() - t0)
                            if tot > 0:
                                _mt.set("bf_overlap_fraction",
                                        hidden / tot, rank=str(r))
                            db.begin()
                            ph["harvest"] += hidden
                        else:
                            p = consume(x, p, observe=True)
                        if elastic:
                            # publish a coherent (x, p): what a joining
                            # peer warm-starts from
                            wins[r].set_self(np.concatenate([x, [p]]))
                        t1 = time.perf_counter()
                        tree = packer.unpack(np.divide(x, p, out=zbuf))
                        t2 = time.perf_counter()
                        loss, grads = loss_and_grad(r, steps[r], tree)
                        losses[r].append(float(loss))
                        t3 = time.perf_counter()
                        packer.pack(grads, out=gvec)
                        gvec *= lr * p
                        x -= gvec
                        t4 = time.perf_counter()
                        if ctl is None or steps[r] % gossip_every == 0:
                            # the plan's local-SGD cadence: on a step
                            # that does not gossip the whole (x, p) stays
                            # local, and mass is trivially conserved
                            payload[:-1] = x
                            payload[-1] = p
                            payload *= frac
                            for j in my_out:
                                wins[j].deposit(
                                    r if cap_slots else slot_of[j][r],
                                    payload, accumulate=True)
                            x *= frac
                            p *= frac
                        t5 = time.perf_counter()
                        if snapshot_every and steps[r] % snapshot_every == 0:
                            # serve-while-training publish: the post-step
                            # (x, p); z = x / p is invariant to the frac
                            # split, so this is round steps[r]'s model,
                            # swapped in atomically with its round stamp
                            # (the in-band `round` leaf lets wire readers
                            # audit the stamp end to end)
                            _snapshots.table().publish(
                                f"{name}:{r}", steps[r],
                                {"x": x, "p": np.array([p]),
                                 "round": np.array([float(steps[r])])})
                            ph["publish"] += time.perf_counter() - t5
                        if rec is not None:
                            rec.end("collective",
                                    key=("async_dsgd", r, steps[r]),
                                    op="async_dsgd_round",
                                    cid="async_dsgd_round",
                                    step=steps[r], rank=r)
                            rec.record("optimizer_step", step=steps[r],
                                       rank=r, loss=float(loss))
                        # the round's wall clock from its boundary (the
                        # skew sleep after it is not counted)
                        _mt.observe("bf_round_seconds",
                                    time.perf_counter() - t0, rank=str(r))
                        ph["consume"] += t1 - t0
                        ph["unpack"] += t2 - t1
                        ph["loss_and_grad"] += t3 - t2
                        ph["pack"] += t4 - t3
                        ph["deposit"] += t5 - t4
                        steps[r] += 1
                        if (stop_after_steps is not None
                                and steps[r] >= stop_after_steps):
                            stop.set()
                            break
                        if skew[r] > 0 or poll_interval_s > 0:
                            time.sleep(skew[r] + poll_interval_s)

                    if not want_leave:
                        # run ended: drain the mass in flight so the
                        # audit is exact; the harvester's staged take is
                        # mass this rank already owns
                        if db is not None:
                            p = consume(x, p, staged=db.close())
                        p = consume(x, p)
                        finals[r] = x / p
                        wins[r].set_self(np.concatenate([x, [p]]))
                        if ctl is not None:
                            final_plans[r] = ctl.plan
                        return

                    # ------------------------------------ graceful drain
                    # fold the landed mass, then hand the whole (x, p) to
                    # live out-neighbours in drain deposits: a leaver's
                    # mass is conserved in the audit
                    if db is not None:
                        p = consume(x, p, staged=db.close())
                        db = None
                    p = consume(x, p)
                    with mem_mu:
                        live = sorted(members - {r})
                    live = [j for j in live if not died[j]]
                    if board is not None:
                        live = [j for j in live
                                if board.state(j) != _res.DEAD]
                    plan = _plan(known_active if known_active
                                 else frozenset({r} | set(live)))
                    tgt = [j for j in plan.out_neighbors(r) if j in live]
                    tgt = tgt or live
                    if tgt:
                        payload[:-1] = x
                        payload[-1] = p
                        payload /= float(len(tgt))
                        for j in tgt:
                            wins[j].deposit_async(r, payload,
                                                  accumulate=True,
                                                  drain=True)
                        x[:] = 0.0
                        p = 0.0
                    # else: no live member to hand off to; keep the mass
                    # and publish it, the audit still counts it
                    wins[r].set_self(np.concatenate([x, [p]]))
                    with mem_mu:
                        members.discard(r)
                        left_final.add(r)
                    if board is not None:
                        board.mark_left(r)
                    else:
                        _bb.record("peer_leave", peer=f"rank{r}", rank=r,
                                   step=steps[r])
                    with mem_mu:
                        n_mem = len(members)
                    _mt.set("bf_members", float(n_mem))
                    finals[r] = None
                    is_member = False
                    # back to the outer loop: a later join offset
                    # re-admits this rank
        except (RankKilled, _chaos.ChaosKill):
            # a killed rank: no drain, no final publish; its last will
            # (the mass carried to the grave, the harvester's staged take
            # included) keeps the audit exact
            died[r] = True
            if db is not None:
                p += sum(float(buf[-1]) for _, buf, _ in db.close())
            died_mass[r] = p
        except BaseException as e:
            errors.append(e)
            stop.set()
        finally:
            if db is not None:
                db.close()  # idempotent; stops the harvester thread

    prof_owned = _arm_profiler(profile, 0)
    threads = [threading.Thread(target=rank_loop, args=(r,), daemon=True)
               for r in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    stop.wait(duration_s)
    stop.set()
    join_budget = max(skew) * 4 + 30.0  # a rank may be mid-gradient
    for t in threads:
        t.join(timeout=join_budget)
    if prof_owned:
        _profiling.reset()  # flushes the tail window before the audit
    if any(t.is_alive() for t in threads):
        raise RuntimeError("async DSGD rank threads failed to stop within "
                           f"{join_budget:.1f}s; aborting without freeing")
    wall = time.perf_counter() - t0
    if snapshot_every:
        for r in range(n):
            _snapshots.table().drop(f"{name}:{r}")
    if errors:
        for w in wins:
            w.free()
        raise errors[0]

    total_mass = 0.0
    for r in range(n):
        if not died[r]:
            # a corpse's published snapshot is stale (its mass is its
            # last will, died_mass); everyone else's final set_self is
            # the truth
            total_mass += float(wins[r].read_self()[-1])
        total_mass += _landed_mass(
            wins[r], [k for k in range(n) if k != r] if cap_slots
            else range(len(in_nbrs[r])))
    # consensus over the survivors (a killed rank has no final z; a
    # leaver handed its state off)
    alive = [r for r in range(n) if finals[r] is not None]
    if alive:
        zs = np.stack([finals[r] for r in alive])
        gap = float(np.abs(zs - zs.mean(axis=0)).max())
    else:
        gap = float("inf")
    report = DSGDReport(
        wall_time_s=wall,
        steps_per_rank=list(steps),
        losses=losses,
        final_params=[packer.unpack(finals[r]) if finals[r] is not None
                      else None for r in range(n)],
        total_mass=total_mass,
        consensus_gap=gap,
        phase_s=phases,
        dead_ranks=[r for r in range(n) if died[r]],
        died_mass=float(sum(died_mass)),
        baseline_mass=(float(len(members0)) + joined_mass[0]
                       if elastic else None),
        health_transitions=(
            {r: board.transitions(r) for r in range(n)}
            if board is not None else None),
        left_ranks=sorted(left_final),
        joined_ranks=sorted(ever_joined),
        # the highest-version plan any rank converged on (decisions are
        # deterministic: ranks differ only in how far their view of the
        # evidence had propagated when the run ended)
        control_plan=max((pl for pl in final_plans if pl is not None),
                         key=lambda pl: pl.version, default=None),
        plan_changes=max(ctl_changes) if control is not None else 0,
    )
    for w in wins:
        w.free()
    return report



# ---------------------------------------------------------------------------
# Cross-process asynchronous training (one OS process per rank, shm windows)
# ---------------------------------------------------------------------------


def shm_unlink_window(name: str) -> bool:
    """Remove a stale shm window segment (one a crashed owner left) by
    window name; True if a segment was removed."""
    return _native.load().bf_win_shm_unlink(name.encode()) == 0


class FileBarrier:
    """A filesystem barrier between rank processes.

    The process runner needs a few rendezvous points around its training
    loop (windows created, deposits stopped, results published, audit
    done) and no collective runtime in between: a shared directory is the
    whole requirement (a network filesystem across hosts).  Rank ``r``
    touches ``<dir>/<stage>.<r>`` and waits until all ``n`` exist.

    :attr:`exclude` is the barrier's fault tolerance: ranks declared DEAD
    (or not members of an elastic job) go in this set and are no longer
    waited for.  The set is re-read every poll, so a rank declared dead
    while others already wait unblocks them at once."""

    def __init__(self, path: str, n_ranks: int, rank: int):
        self.path = path
        self.n = int(n_ranks)
        self.rank = int(rank)
        self.exclude: set = set()
        os.makedirs(path, exist_ok=True)

    def wait(self, stage: str, timeout_s: float = 120.0) -> None:
        open(os.path.join(self.path, f"{stage}.{self.rank}"), "w").close()

        def missing_ranks():
            return [r for r in range(self.n)
                    if r not in self.exclude and not os.path.exists(
                        os.path.join(self.path, f"{stage}.{r}"))]

        t0 = time.perf_counter()
        while missing_ranks():
            if time.perf_counter() - t0 > timeout_s:
                # rank numbers, not paths: the cross-rank merge names the
                # absent rank, and the event makes the timeout part of the
                # incident record before the raise unwinds this process
                _bb.record("barrier_timeout", stage=stage,
                           missing_ranks=missing_ranks(), rank=self.rank,
                           waited_s=round(time.perf_counter() - t0, 3),
                           dir=self.path)
                raise TimeoutError(
                    f"barrier {stage!r} timed out after {timeout_s:.0f}s "
                    f"on rank {self.rank}; missing rank(s) "
                    f"{missing_ranks()} (dir {self.path})")
            time.sleep(0.005)


class _ShmTransport:
    """Same-host rank processes: windows in named shared memory."""

    def create(self, wname: str, n_slots: int, n_elems: int) -> AsyncWindow:
        # each rank owns its window names, so a leftover segment can only
        # be stale (a crashed earlier run): clean it and create anew
        shm_unlink_window(wname)
        return AsyncWindow(wname, n_slots, n_elems, np.float64, shm=True)

    def publish(self, barrier: FileBarrier, rank: int) -> None:
        pass  # the shm namespace is the rendezvous

    def collect(self, barrier: FileBarrier, ranks) -> None:
        pass

    def open(self, owner: int, wname: str, n_slots: int, n_elems: int):
        return AsyncWindow(wname, attach=True)

    def wire_bytes(self) -> int:
        return 0

    def stream_stats(self) -> Dict[str, object]:
        return {}

    def close(self) -> None:
        pass


class _RemoteHandle:
    """AsyncWindow-shaped adapter over a
    :class:`~bluefog_tpu_torch.runtime.window_server.RemoteWindow` or
    :class:`~bluefog_tpu_torch.runtime.window_server.
    PipelinedRemoteWindow` (the geometry is captured at open time, as the
    remote protocol needs it on every call)."""

    def __init__(self, rw, n_slots: int, n_elems: int):
        self._rw = rw
        self.n_slots = n_slots
        self.n_elems = n_elems
        self.dtype = np.dtype(np.float64)

    def deposit(self, slot, arr, *, accumulate=True):
        return self._rw.deposit(
            slot, np.ascontiguousarray(arr, self.dtype),
            accumulate=accumulate)

    def deposit_async(self, slot, arr, *, accumulate=True, copy=True,
                      drain=False):
        """Fire-and-forget on the pipelined transport; synchronous (the
        same result, not overlapped) on the plain one, where the drain
        mark is carried by the owner's audit protocol instead of a wire
        flag."""
        fn = getattr(self._rw, "deposit_async", None)
        a = np.ascontiguousarray(arr, self.dtype)
        if fn is None:
            return self._rw.deposit(slot, a, accumulate=accumulate)
        return fn(slot, a, accumulate=accumulate, copy=copy, drain=drain)

    @property
    def health(self):
        """Peer health of the underlying pipelined stream (None on the
        sync client or when resilience is off)."""
        return getattr(self._rw, "health", None)

    def ack_ewma(self) -> Optional[float]:
        fn = getattr(self._rw, "ack_ewma", None)
        return None if fn is None else fn()

    @property
    def reconnects(self) -> int:
        return int(getattr(self._rw, "reconnects", 0))

    def set_codec(self, codec: Optional[str]) -> None:
        fn = getattr(self._rw, "set_codec", None)
        if fn is not None:
            fn(codec)
        elif codec not in (None, "none"):
            raise ValueError(
                "the synchronous window client has no wire codec; "
                f"cannot set {codec!r}")

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Fence for :meth:`deposit_async` (a no-op on the sync client)."""
        fn = getattr(self._rw, "flush", None)
        if fn is not None:
            fn(timeout_s)

    def read(self, slot, *, consume=True):
        return self._rw.read(slot, self.n_elems, self.dtype, consume=consume)

    def read_self(self):
        return self._rw.read_self(self.n_elems, self.dtype)

    def free(self):
        self._rw.close()


class _TcpTransport:
    """Rank processes on any hosts: process-local windows served over TCP
    (:mod:`bluefog_tpu_torch.runtime.window_server`).  Addresses
    rendezvous through the barrier directory (one ``winaddr.<rank>`` file
    per rank).

    ``pipeline=True`` (the default) opens peers as
    :class:`~bluefog_tpu_torch.runtime.window_server.PipelinedRemoteWindow`:
    deposits are fire-and-forget through a per-peer background sender
    (batched frames, windowed acks) and the DSGD loop fences with
    ``flush()`` before its audit barrier.  ``wire_codec`` selects lossy
    wire compression (``"f32"``/``"topk"``), opt-in, and off whenever the
    exact push-sum mass audit matters.

    Three keys of ``stream_options`` are consumed here (the rest forward
    to the per-peer :class:`~bluefog_tpu_torch.runtime.window_server.
    DepositStream`):

    - ``shm=True``: the same-host route.  This rank's own windows go into
      named shared memory (so co-located peers can attach them) and its
      deposit streams route same-host deposits through the shm table
      instead of TCP, falling back to TCP when the owner is on another
      host.
    - ``stripes=N``: one shared
      :class:`~bluefog_tpu_torch.runtime.window_server.
      StripedDepositStream` per peer (N parallel connections).
    - ``transport_tuning=True | TransportConfig(...)``: arms the
      closed-loop stripe and coalescing autotuner.  The runner calls
      :meth:`retune_transport_at_round_boundary` at its round boundaries,
      and each peer's plan follows the ack-latency EWMA its stripes
      collect (without phase evidence until tracing grants it, as for an
      untraced connection in the JAX package).  Tuning arms a one-stripe
      pool where ``stripes`` was not given."""

    def __init__(self, bind_host: str = "0.0.0.0", *, pipeline: bool = True,
                 wire_codec: Optional[str] = None,
                 resilience: Optional[_res.ResilienceConfig] = None,
                 stream_options: Optional[Dict] = None):
        from bluefog_tpu_torch.runtime.window_server import WindowServer

        self._stream_options = dict(stream_options or {})
        self._shm = bool(self._stream_options.pop("shm", False))
        self._n_stripes = int(self._stream_options.pop("stripes", 0))
        tuning = self._stream_options.pop("transport_tuning", None)
        self._tuning = (_TransportConfig() if tuning is True
                        else tuning)  # None or a TransportConfig
        if self._tuning is not None and self._n_stripes <= 0:
            # the autotuner's knobs live on the striped stream: arm a
            # minimal pool it can widen from
            self._n_stripes = 1
        self._plans: Dict[int, _TransportPlan] = {}
        self._server = WindowServer()
        self._server.start(bind_host)
        self._pipeline = pipeline
        self._codec = wire_codec
        self._resilience = resilience
        self._striped: Dict[int, object] = {}  # owner -> striped stream
        self._streams: List = []               # every stream opened
        self._peer_streams: Dict[int, List] = {}  # owner -> its streams
        self._addrs: Dict[int, Tuple[str, int]] = {}

    def create(self, wname: str, n_slots: int, n_elems: int) -> AsyncWindow:
        if self._shm and _native.enabled():
            # this rank's windows go into the named-shm table, so
            # co-located peers' deposit streams can attach them; the name
            # is rank-owned, so a leftover segment is a stale artifact
            shm_unlink_window(wname)
            return AsyncWindow(wname, n_slots, n_elems, np.float64,
                               shm=True)
        return AsyncWindow(wname, n_slots, n_elems, np.float64)

    def publish(self, barrier: FileBarrier, rank: int) -> None:
        host, port = self._server.address
        path = os.path.join(barrier.path, f"winaddr.{rank}")
        with open(path + ".tmp", "w") as f:
            f.write(f"{host}:{port}")
        os.replace(path + ".tmp", path)

    def collect(self, barrier: FileBarrier, ranks,
                timeout_s: float = 60.0) -> None:
        # the barrier directory may be a network filesystem across hosts:
        # another host's winaddr file can lag the barrier, so poll.
        # ``ranks`` is the set to resolve: the current member set of an
        # elastic job, or one newly announced joiner
        deadline = time.perf_counter() + timeout_s
        for r in ranks:
            path = os.path.join(barrier.path, f"winaddr.{r}")
            while True:
                try:
                    with open(path) as f:
                        host, port = f.read().strip().rsplit(":", 1)
                    break
                except (FileNotFoundError, ValueError):
                    # ValueError: the file is visible but not written yet
                    if time.perf_counter() > deadline:
                        raise TimeoutError(
                            f"rank {r}'s window address never appeared at "
                            f"{path}")
                    time.sleep(0.01)
            self._addrs[r] = (host, int(port))

    def open(self, owner: int, wname: str, n_slots: int, n_elems: int):
        from bluefog_tpu_torch.runtime.window_server import (
            PipelinedRemoteWindow, RemoteWindow, StripedDepositStream)

        if self._pipeline:
            cfg = self._resilience
            res_kw = {}
            if cfg is not None:
                res_kw = dict(
                    reconnect=cfg.backoff_kwargs(),
                    heartbeat_interval_s=cfg.heartbeat_interval_s or 0.0,
                    suspect_after_s=cfg.suspect_after_s,
                    dead_after_s=cfg.dead_after_s)
            # the runner's own sync reads (the warm start's read_self,
            # the audit) retry torn or timed-out replies on a fresh
            # connection under the same bounded budget
            sync_retry = cfg.backoff_kwargs() if cfg is not None else None
            if self._n_stripes > 0:
                # one shared per-peer stripe pool: every window bound for
                # this owner rides it, and a handle's flush fences all
                # stripes at once
                st = self._striped.get(owner)
                if st is None:
                    st = StripedDepositStream(
                        self._addrs[owner], n_stripes=self._n_stripes,
                        codec=self._codec, shm=self._shm,
                        **res_kw, **self._stream_options)
                    self._striped[owner] = st
                    self._streams.append(st)
                    self._peer_streams.setdefault(owner, []).append(st)
                    self._plans[owner] = _TransportPlan(
                        stripes=st.n_stripes,
                        coalesce_bytes=self._stream_options.get(
                            "max_batch_bytes", 16 << 20))
                rw = PipelinedRemoteWindow(self._addrs[owner], wname,
                                           stream=st, sync_retry=sync_retry)
            else:
                if "heartbeat_interval_s" in res_kw:
                    res_kw["heartbeat_interval_s"] = (
                        res_kw["heartbeat_interval_s"] or None)
                rw = PipelinedRemoteWindow(
                    self._addrs[owner], wname, codec=self._codec,
                    shm=self._shm or None, sync_retry=sync_retry,
                    **res_kw, **self._stream_options)
                self._streams.append(rw.stream)
                self._peer_streams.setdefault(owner, []).append(rw.stream)
        else:
            rw = RemoteWindow(self._addrs[owner], wname)
        return _RemoteHandle(rw, n_slots, n_elems)

    def wire_bytes(self) -> int:
        """Bytes this rank's deposit streams put on the wire."""
        return int(sum(st.wire_bytes for st in self._streams))

    def stream_stats(self) -> Dict[str, object]:
        """This rank's streams' reconnects, replayed and retired batches,
        the duplicates its own server deduped, and each peer's ack-latency
        EWMA (seconds; the slowest of the peer's streams)."""
        def total(attr):
            return int(sum(getattr(st, attr, 0) for st in self._streams))

        ewma = {}
        phases = {}
        for owner, sts in sorted(self._peer_streams.items()):
            vals = [v for v in (st.ack_ewma() for st in sts) if v is not None]
            if vals:
                ewma[owner] = max(vals)
            split = [v for v in (st.phase_ewma() for st in sts)
                     if v is not None]
            if split:
                phases[owner] = {k: max(v[k] for v in split)
                                 for k in split[0]}
        out = {"reconnects": total("reconnects"),
               "replayed": total("replayed_batches"),
               "retired": total("retired_batches"),
               "deduped": int(self._server.deduped_batches),
               "ack_ewma_s": ewma}
        if phases:
            # traced streams only: each peer's {net, queue, apply} split
            # of its ack latency (the slowest of its streams, per phase)
            out["phase_s"] = phases
        return out

    def retune_transport_at_round_boundary(self, round_: int) -> None:
        """The closed-loop transport autotune, called by the DSGD runner
        at its round boundaries: per peer, the stripe pool's ack-latency
        EWMA goes through the pure :func:`~bluefog_tpu_torch.control.
        decide_transport_plan` step, and the plan is actuated only when a
        hysteresis band was crossed (the no-change case returns the
        previous plan object itself)."""
        if self._tuning is None:
            return
        for owner, st in self._striped.items():
            prev = self._plans[owner]
            plan = _decide_transport_plan(
                prev, round_, ack_ewma_s=st.ack_ewma(),
                phase_s=st.phase_ewma(), cfg=self._tuning)
            if plan is not prev:
                st.apply_plan(plan)
                self._plans[owner] = plan

    def close(self) -> None:
        for st in self._striped.values():
            try:
                st.close()
            except Exception:
                pass
        self._striped.clear()
        self._server.stop()


def run_async_dsgd_rank(
    topology: Topology,
    rank: int,
    params0,
    loss_and_grad,
    *,
    barrier: FileBarrier,
    lr: float = 0.05,
    duration_s: float = 3.0,
    skew_s: float = 0.0,
    name: str = "async_dsgd_mp",
    poll_interval_s: float = 0.0,
    transport: str = "shm",
    tcp_bind: str = "0.0.0.0",
    wire_codec: Optional[str] = None,
    resilience: Optional[_res.ResilienceConfig] = None,
    join: bool = False,
    leave_after_s: Optional[float] = None,
    initial_members: Optional[Sequence[int]] = None,
    snapshot_every: int = 0,
    control=None,
    stop_after_steps: Optional[int] = None,
    stream_options: Optional[Dict] = None,
    fleet=None,
    profile=None,
    overlap: bool = False,
) -> Optional[DSGDReport]:
    """One rank of an asynchronous decentralized SGD run in which every
    rank is its own OS process: the reference's deployment shape
    (``mpirun -np N``) rather than :func:`run_async_dsgd`'s threads.

    Each process creates its landing window and deposits into its
    out-neighbours' windows directly: a cross-process ``MPI_Put`` with no
    receiver involvement and no barrier in the training loop.  ``barrier``
    fires four times, all outside the loop: windows created, deposits
    stopped, results published, audit done.  The algorithm and its mass
    invariant are those of :func:`run_async_dsgd`; ``skew_s`` is this
    rank's extra sleep per step, ``stop_after_steps`` ends this rank's
    loop after that many steps (``duration_s`` stays the cap), and
    ``overlap=True`` harvests landed deposits under the gradient
    (:class:`DoubleBuffer`).  When ``params0`` lives on the card, the
    gradient runs there and :class:`TreePacker` carries it to the window.

    ``transport`` selects the fabric: ``"shm"`` (named shared memory, ranks
    on one host), ``"tcp"`` (each process serves its windows through a
    :class:`~bluefog_tpu_torch.runtime.window_server.WindowServer`; ranks
    may live on different hosts when the barrier directory is shared;
    deposits ride the pipelined batched client and the loop fences with
    ``flush()`` before the audit barrier), or ``"tcp-sync"`` (one
    blocking round trip a deposit, kept for comparison).  ``wire_codec``
    (``"f32"``/``"topk"``, tcp only) turns on lossy wire compression:
    leave it ``None`` whenever the exact mass audit matters.
    ``stream_options`` forwards DepositStream tuning (``max_in_flight``,
    ``max_queue_items``, ``max_batch_bytes``) and takes ``shm=True`` (the
    same-host route with TCP fallback), ``stripes=N`` and
    ``transport_tuning=True | TransportConfig(...)`` (see
    :class:`_TcpTransport`; the runner retunes every 16 rounds).

    ``resilience`` (tcp only) opts into peer-fault tolerance: deposit
    streams reconnect with bounded backoff and replay their unacked
    batches; a SUSPECT peer's share is withheld (kept, not deposited:
    unbiased under the push-sum weight channel, and the sender stops
    bleeding mass into a possible corpse); a peer whose reconnect budget
    is exhausted is declared DEAD, announced to the other survivors
    through a ``dead.<r>`` tombstone in the barrier directory, and healed
    out of the mixing weights.  The survivors then hold a
    quiesce-rendezvous (fence and heal barrier, dead ranks excluded) and
    record the surviving set's exact mass as ``report.baseline_mass``:
    the final audit must reproduce it (``report.total_mass ==
    report.baseline_mass``).  Rank 0, the reporting rank, must survive,
    and one failure settles before the next is detected.

    Elastic membership (tcp; needs ``resilience=``): ``topology`` is the
    job's capacity, and slot indices are rank numbers, so the windows
    survive any membership change.  ``initial_members`` names the ranks
    that start the job (default: all).  A later process calls this
    function with ``join=True`` on a reserved (or departed) rank: it
    starts its window server, warm-starts by reading a live member's
    published ``(x, p)`` from its window (no checkpoint file anywhere),
    announces itself through a ``member.<r>`` record in the barrier
    directory, and is admitted at a round boundary through a
    quiesce-rendezvous that re-measures the exact baseline over the grown
    member set.  ``leave_after_s`` triggers the graceful drain: the
    leaver fences its streams, waits for the members to fence theirs,
    hands its whole push-sum mass to its out-neighbours in final
    drain-flagged deposits (conserved in the audit), writes ``left.<r>``
    and returns.  The live ranks re-plan the mixing graph over the
    current member set (:func:`~bluefog_tpu_torch.topology.graphs.
    replan`) at every membership boundary.  Rank 0 must be a stable
    initial member; membership events settle one at a time.

    ``control`` (tcp and ``resilience=``; every rank of the job passes
    the same config) runs the communication control plane: each process
    runs a :class:`~bluefog_tpu_torch.control.CommController` fed by its
    deposit streams' ack EWMA, health states and reconnect counts, the
    local disagreement and a :class:`~bluefog_tpu_torch.metrics.health.
    MixingTracker`; every ``evidence_every`` rounds it writes its
    ``ctlev.<rank>`` record into the barrier directory, decides over the
    records of the ranks not tombstoned, and at a plan change installs
    the penalized mixing graph, the gossip cadence and (with
    ``max_codec_level > 0``, which needs ``wire_codec`` at that ceiling)
    the wire codec.  Heals and membership changes then route through the
    plan as well.  A plan moves edges, never mass, so the exact audit
    holds through it.  Chaos (``BLUEFOG_TPU_CHAOS``) acts here too:
    ``rank<N>:sigkill``/``:sigstop`` at a step or after a time, and
    ``rank<N>:leave:at_step`` as a graceful drain (elastic jobs only).

    ``snapshot_every > 0`` publishes this rank's round-stamped ``(x, p,
    round)`` into the process-global serving table every Nth step (group
    ``f"{name}:{rank}"``), after any heal, so the published pair is the
    rank's post-step state; over tcp the rank's own ``WindowServer``
    serves it to :class:`~bluefog_tpu_torch.serving.client.SnapshotClient`
    readers and :class:`~bluefog_tpu_torch.serving.subscriber.Subscriber`
    push channels (over shm, a ``WindowServer`` the caller starts in this
    process does).  Readers never touch the training loop; the group is
    dropped when the rank returns.  ``rep.phase_s`` then has a
    ``publish`` entry.

    ``profile`` names a (shared) directory for the sampling profiler
    (:mod:`bluefog_tpu_torch.profiling`): this process arms a sampler
    writing phase-attributed folded stacks to ``profile-rank<rank>.jsonl``
    there and stops it when the rank returns; one armed by
    ``BLUEFOG_TPU_PROFILE`` is left running.  Merge the files with
    ``python -m bluefog_tpu_torch.profiling DIR``.  With tracing armed
    (``BLUEFOG_TPU_TRACE`` or :func:`bluefog_tpu_torch.tracing.configure`)
    the rank writes ``trace-rank<rank>.jsonl``, flushed when it returns.

    Not ported yet, raising ``NotImplementedError``: ``fleet`` (ROADMAP
    Queue 1 item 11).

    Returns a :class:`DSGDReport` on rank 0 (``losses`` and ``phase_s``
    filled at index ``rank`` only; the other ranks' stay in their
    processes), and ``None`` elsewhere (joiners and leavers included).
    """
    _check_dsgd_args(snapshot_every=snapshot_every, fleet=fleet)
    if control is not None and transport != "tcp":
        raise ValueError(
            "the communication control plane rides the tcp transport's "
            "telemetry (ack EWMA, heartbeats, reconnect counters); "
            f"transport={transport!r} has none")
    if control is not None and resilience is None:
        raise ValueError(
            "the communication control plane needs "
            "resilience=ResilienceConfig(...): heartbeats are what keep "
            "a penalized (idle) stream's ack EWMA fresh; without them "
            "the lag evidence freezes at its worst value and hysteresis "
            "could never release a recovered peer")
    if control is not None and control.max_codec_level > 0:
        from bluefog_tpu_torch.control import CODEC_LADDER

        if wire_codec != CODEC_LADDER[control.max_codec_level]:
            raise ValueError(
                "control.max_codec_level="
                f"{control.max_codec_level} needs the streams opened at "
                f"that ceiling: pass wire_codec="
                f"{CODEC_LADDER[control.max_codec_level]!r} (the "
                "controller backs off from the negotiated ceiling; it "
                "cannot step above it)")
    if transport == "shm":
        tx = _ShmTransport()
    elif transport == "tcp":
        tx = _TcpTransport(tcp_bind, pipeline=True, wire_codec=wire_codec,
                           resilience=resilience,
                           stream_options=stream_options)
    elif transport == "tcp-sync":
        tx = _TcpTransport(tcp_bind, pipeline=False)
    else:
        raise ValueError(
            f"transport must be 'shm', 'tcp' or 'tcp-sync', got "
            f"{transport!r}")
    # the profiler is per process, so each rank writes its own file into
    # the shared directory
    prof_owned = _arm_profiler(profile, rank)
    # the transport may hold live resources already (the TCP server's
    # thread and socket start in its constructor): everything from here
    # on, setup failures included, must release them
    opened: List = []
    db: Optional[DoubleBuffer] = None
    try:
        elastic = bool(join or leave_after_s is not None
                       or initial_members is not None)
        if elastic and transport != "tcp":
            raise ValueError(
                "elastic membership (join/leave/initial_members) requires "
                "transport='tcp' (member discovery rides the winaddr "
                "records; the shm namespace has none)")
        if (wire_codec is not None or stream_options) \
                and transport != "tcp":
            raise ValueError("wire_codec= and stream_options= ride the "
                             "pipelined tcp transport")
        d = TreePacker(params0, np.float64).size
        # elastic and control-plane jobs take one landing slot per
        # capacity rank (slot == source rank, stable under membership
        # change and controller replans); fixed fleets keep the dense
        # in-degree sizing
        if elastic or control is not None:
            n_slots = topology.size
            db_slots = [k for k in range(n_slots) if k != rank]
        else:
            n_slots = max(len(list(topology.in_neighbors(rank))), 1)
            db_slots = list(range(n_slots))
        win = tx.create(f"{name}:{rank}", n_slots, d + 1)
        opened.append(win)
        if overlap:
            # the harvester lives here, so the finally stops its thread
            # before any window is freed, on every exit path
            db = DoubleBuffer(win, db_slots, d + 1)

        def _create(wname, n_slots, n_elems):
            w = tx.create(wname, n_slots, n_elems)
            opened.append(w)
            return w

        def _open(owner, wname, n_slots, n_elems):
            w = tx.open(owner, wname, n_slots, n_elems)
            opened.append(w)
            return w

        return _run_dsgd_rank_body(
            topology, rank, params0, loss_and_grad, barrier=barrier, lr=lr,
            duration_s=duration_s, skew_s=skew_s, name=name,
            poll_interval_s=poll_interval_s, win=win, transport=tx,
            create_window=_create, open_window=_open,
            resilience=resilience if transport == "tcp" else None,
            join=join, leave_after_s=leave_after_s,
            initial_members=initial_members, control=control,
            stop_after_steps=stop_after_steps, overlap_buffer=db,
            snapshot_every=snapshot_every)
    finally:
        if db is not None:
            db.close()  # idempotent; before the windows are freed
        if prof_owned:
            _profiling.reset()  # joins the sampler, flushes the tail
        if snapshot_every:
            _snapshots.table().drop(f"{name}:{rank}")
        # land this rank's spans before the run returns (the exit hook
        # flushes too, but one process may run several jobs into one
        # trace directory); a no-op with tracing off
        _tr.flush()
        for w in opened:
            try:
                w.free()
            except Exception:
                pass
        tx.close()


def _write_roster(path: str, members) -> None:
    """Rank 0's record of an elastic job's initial members (atomic)."""
    p = os.path.join(path, "roster")
    with open(p + ".tmp", "w") as f:
        f.write(",".join(str(r) for r in sorted(members)))
    os.replace(p + ".tmp", p)


def _read_roster(path: str) -> Optional[set]:
    """The initial members rank 0 recorded, or None before it did."""
    try:
        with open(os.path.join(path, "roster")) as f:
            return {int(r) for r in f.read().split(",") if r}
    except OSError:
        return None


def _run_dsgd_rank_body(topology, rank, params0, loss_and_grad, *, barrier,
                        lr, duration_s, skew_s, name, poll_interval_s, win,
                        transport, create_window, open_window,
                        resilience=None, join=False, leave_after_s=None,
                        initial_members=None, control=None,
                        stop_after_steps=None, overlap_buffer=None,
                        snapshot_every=0):
    from bluefog_tpu_torch.utils.logging import log as _log

    n = topology.size
    packer = TreePacker(params0, np.float64)
    d = packer.size
    cfg = resilience
    inj = _chaos.get()
    chaos_leave = (inj is not None and any(
        ru.site == "rank" and ru.rank == rank and ru.fault == "leave"
        for ru in inj.rules))
    # elasticity is decided by the arguments, which every rank of a job
    # shares: a chaos leave rule alone cannot flip one process into the
    # elastic slot scheme while its peers stay dense
    elastic = bool(join or leave_after_s is not None
                   or initial_members is not None)
    if chaos_leave and not elastic:
        raise ValueError(
            "a rankN:leave chaos rule needs an elastic job (every rank "
            "must run the membership protocol): start the fleet with "
            "initial_members=/join=/leave_after_s= on all ranks")
    if elastic and cfg is None:
        raise ValueError(
            "elastic membership (join/leave/initial_members) rides the "
            "resilient rendezvous machinery; pass "
            "resilience=ResilienceConfig(...)")
    if (join or leave_after_s is not None or chaos_leave) and rank == 0:
        raise ValueError("rank 0 is the reporting rank and must be a "
                         "stable initial member (cannot join or leave)")
    members: set = (set(range(n)) if initial_members is None
                    else {int(r) for r in initial_members})
    if not join and rank not in members:
        raise ValueError(f"rank {rank} is not in initial_members "
                         f"{sorted(members)} (a later process joins "
                         "with join=True)")
    meta = None
    dead: set = set()
    left: set = set()
    ever_joined: set = set()
    handled: set = set()  # (kind, rank, token) records already consumed
    losses: List[float] = []
    steps = 0
    baseline_mass: Optional[float] = None
    exact = True  # False once a failure escapes the rendezvous protocol

    x = packer.pack(params0)
    p = 1.0
    gvec = np.empty(d, np.float64)
    zbuf = np.empty(d, np.float64)
    payload = np.empty(d + 1, np.float64)
    self_buf = np.empty(d + 1, np.float64)
    # this process's flight recorder (None when off), named by its rank so
    # a shared incident directory gets blackbox-rank<r>.jsonl per rank
    rec = _bb.get()
    if rec is not None and rec.rank is None:
        rec.rank = rank
    peers: Dict[int, object] = {}
    ph = dict.fromkeys(("consume", "unpack", "loss_and_grad", "pack",
                        "deposit", "harvest")
                       + (("publish",) if snapshot_every else ()), 0.0)
    # one process a rank: pin the trace file's identity before the first
    # flush names it (a no-op with tracing off)
    _tr.set_rank(rank)
    _chaos.arm(rank)

    # ------------------------------------------- control plane (opt-in)
    ctl = (_CommController(rank, n, config=control)
           if control is not None else None)
    tracker: Optional[_MixingTracker] = None
    tracker_members: Optional[frozenset] = None
    gossip_every = 1
    if ctl is not None:
        _ctlev.clear_evidence(barrier.path, rank)  # a previous life's
    # the striped transport's autotuner (tcp with transport_tuning): the
    # runner drives its closed loop at round boundaries
    retune = getattr(transport, "retune_transport_at_round_boundary", None)

    # slot scheme (the shared arguments make every rank agree): elastic
    # and control-plane runs use slot index == source rank over capacity
    # slots; fixed fleets keep the dense in-neighbour mapping
    cap_slots = elastic or control is not None
    in_nbrs = list(topology.in_neighbors(rank))
    my_slots = ([k for k in range(n) if k != rank] if cap_slots
                else list(range(len(in_nbrs))))
    db: Optional[DoubleBuffer] = overlap_buffer

    def _peer_slots(j: int) -> int:
        return (n if cap_slots
                else max(len(list(topology.in_neighbors(j))), 1))

    def _slot_in(j: int) -> int:
        """Our landing slot in peer j's window."""
        return (rank if cap_slots
                else list(topology.in_neighbors(j)).index(rank))

    def _ensure_peer(j: int):
        if j not in peers:
            peers[j] = open_window(j, f"{name}:{j}", _peer_slots(j),
                                   d + 1)
        return peers[j]

    def _make_plan():
        """The mixing plan over the current member set at this round
        boundary: the controller's penalized rebuild when the control
        plane is on (heals and membership changes then keep the plan's
        penalties), a fresh replan for elastic fleets, the renormalising
        heal for fixed ones.  Deterministic in (members, dead, CommPlan),
        so every rank that has seen the same records converges on the
        same matrix with no extra coordination."""
        nonlocal tracker, gossip_every, tracker_members
        t0p = time.perf_counter()
        if ctl is None:
            plan = (_replan(topology, members - dead) if elastic
                    else _heal(topology, dead))
            _mt.observe("bf_replan_seconds", time.perf_counter() - t0p)
            _mt.set("bf_members", float(len(members - dead)))
            return plan
        plan = ctl.apply_plan(topology=topology, members=members - dead)
        _mt.observe("bf_replan_seconds", time.perf_counter() - t0p)
        _mt.set("bf_members", float(len(members - dead)))
        gossip_every = ctl.plan.gossip_every
        # the feed-window exponent follows the cadence in effect
        rpu = max(1, round(control.evidence_every / gossip_every))
        live = frozenset(members - dead)
        if tracker is None:
            tracker = _MixingTracker(plan, rounds_per_update=rpu)
        else:
            if tracker_members is not None and live != tracker_members:
                # a membership boundary: drop the sample taken over
                # another member set
                tracker.reset_measurement()
            tracker.rebase(plan, rounds_per_update=rpu)
        tracker_members = live
        return plan

    def _ctl_round_boundary() -> None:
        """Control-plane work at a round boundary: harvest the streams'
        telemetry, publish this rank's evidence record, decide over the
        disseminated records and, when the plan version advanced, install
        the new penalized mixing plan, cadence and codec before the next
        round's deposits leave.  A plan moves edges, cadence and codec,
        never mass, so the exact audit holds through it."""
        nonlocal my_out, frac
        # a corpse or a leaver is off this rank's observation surface:
        # forget its sticky observations, or the frozen last look would
        # be republished in every record
        for j in sorted(dead | left):
            ctl.forget_peer(j)
        for j, h in sorted(peers.items()):
            if j in dead or j in left:
                continue
            hp = h.health
            pe = getattr(h, "phase_ewma", None)
            # phase_s: the traced wire-phase split (net / queue / apply)
            # of the lag, the slow-link against slow-host evidence; None
            # when tracing is off or the connection was not granted
            # FEATURE_TRACE
            ctl.note_peer(j, lag_s=h.ack_ewma(),
                          state=hp.state if hp is not None else None,
                          reconnects_total=h.reconnects,
                          phase_s=pe() if pe is not None else None)
        d_now = ctl.disagreement
        if tracker is not None and d_now is not None:
            measured = tracker.update(d_now)
            excess = None
            if (measured is not None and tracker.predicted is not None
                    and measured < 1.0):
                # interpretable only while gossip contracts; at the SGD
                # equilibrium the growth band governs instead
                excess = measured - tracker.predicted
            ctl.note_mixing_excess(excess)
        _ctlev.write_evidence(barrier.path, ctl.evidence(steps))
        prev_version = ctl.plan.version
        # a corpse's stale record must not keep voting: filter by the
        # tombstone view, which every rank converges on
        evs = [ev for ev in _ctlev.read_evidence(barrier.path, n)
               if ev.rank not in dead]
        new_plan = ctl.decide(steps, evs)
        if new_plan.version == prev_version:
            return
        plan_topo = _make_plan()  # routes through ctl.apply_plan
        my_out = list(plan_topo.out_neighbors(rank))
        frac = 1.0 / (len(my_out) + 1)
        if control.max_codec_level > 0:
            # retune the wire within the negotiated ceiling
            for j, h in sorted(peers.items()):
                if j in dead:
                    continue
                try:
                    h.set_codec(new_plan.codec)
                except (RuntimeError, OSError, ValueError):
                    pass  # a dying handle's codec no longer matters

    def _local_mass() -> float:
        """Own p plus unconsumed landing-slot mass, valid only while
        nothing is in flight (inside a quiesce-rendezvous).  The overlap
        harvester's staged take is mass this rank already holds: pause
        it and count that too."""
        local = p
        if db is not None:
            db.pause()
            local += db.staged_mass()
        return local + _landed_mass(win, my_slots)

    def _mass_rendezvous(stage: str) -> float:
        """Second half of a quiesce-rendezvous: publish the local mass,
        meet at ``<stage>-resume``, and sum the member set's mass files,
        the exact baseline every later audit must reproduce."""
        mpath = os.path.join(barrier.path, f"{stage}.mass.{rank}")
        with open(mpath + ".tmp", "w") as f:
            # repr of a Python float round-trips to the same binary64
            f.write(repr(float(_local_mass())))
        os.replace(mpath + ".tmp", mpath)
        barrier.wait(stage + "-resume", timeout_s=cfg.barrier_timeout_s)
        total = 0.0
        for r2 in sorted(members - dead):
            with open(os.path.join(barrier.path,
                                   f"{stage}.mass.{r2}")) as f:
                total += float(f.read())
        return total

    # ---------------------------------------------------- fault handling
    def _tombstone(j: int) -> None:
        # announce a death to survivors that may never touch the dead
        # rank's transport themselves (the barrier directory is the one
        # shared medium every rank already polls)
        try:
            open(os.path.join(barrier.path, f"dead.{j}"), "w").close()
        except OSError:
            pass

    def _tombstoned() -> set:
        return {r2 for r2 in sorted(members)
                if r2 != rank and r2 not in dead and os.path.exists(
                    os.path.join(barrier.path, f"dead.{r2}"))}

    def _heal_and_rebase(newly: set) -> None:
        """Declare ``newly`` DEAD, heal the mixing weights over the
        survivors, and hold the quiesce-rendezvous that makes the
        surviving set's mass auditable exactly: every survivor fences its
        live peers, meets at a heal barrier (the dead excluded), and
        measures its local mass while nothing is in flight."""
        nonlocal my_out, frac, baseline_mass, exact
        pending = set(newly)
        while pending:
            for j in sorted(pending):
                _bb.record("peer_dead", peer=f"rank{j}", rank=rank,
                           step=steps)
                _mt.set("bf_peer_state", float(_res.DEAD), peer=f"rank{j}")
                _tombstone(j)
            dead.update(pending)
            barrier.exclude |= pending
            for j in pending:
                peers.pop(j, None)  # the caller's finally frees it
            pending = set()
            plan = _make_plan()
            my_out = list(plan.out_neighbors(rank))
            frac = 1.0 / (len(my_out) + 1)
            # fence the survivors: nothing of ours may be in flight when
            # the baseline is measured; a fence that fails names the
            # next corpse
            for j in sorted(my_out):
                try:
                    _ensure_peer(j).flush(cfg.barrier_timeout_s)
                except (RuntimeError, TimeoutError, OSError):
                    pending.add(j)
        stage = "heal" + "".join(f"-{j}" for j in sorted(dead))
        try:
            barrier.wait(stage, timeout_s=cfg.barrier_timeout_s)
            # between the two heal barriers no survivor deposits, so the
            # local mass is the whole truth
            baseline_mass = _mass_rendezvous(stage)
        except (TimeoutError, OSError, ValueError) as e:
            # a survivor never made the rendezvous (it left the loop
            # first, or a second failure overlapped the first): the run
            # goes on healed, but the exactness claim is withdrawn
            baseline_mass = None
            exact = False
            _log.warn("rank %d: heal rendezvous %r degraded (%s: %s); "
                      "continuing without an exact baseline", rank, stage,
                      type(e).__name__, e)
        _bb.record("peer_dead_healed", rank=rank, dead=sorted(dead),
                   step=steps, exact=exact)

    # ------------------------------------------------ elastic membership
    def _admit_joiner(j: int, token: str) -> None:
        """A ``member.<j>`` record appeared: admit the joiner at this
        round boundary.  The quiesce-rendezvous (fence, join barrier,
        mass files) re-establishes the exact baseline over the grown
        member set; the joiner's fresh ``p = 1`` enters the books here."""
        nonlocal my_out, frac, baseline_mass, exact
        _bb.record("peer_join", peer=f"rank{j}", rank=rank, step=steps)
        _mt.set("bf_peer_state", float(_res.JOINING), peer=f"rank{j}")
        transport.collect(barrier, [j])
        members.add(j)
        dead.discard(j)
        left.discard(j)
        ever_joined.add(j)
        barrier.exclude.discard(j)
        plan = _make_plan()
        my_out = list(plan.out_neighbors(rank))
        frac = 1.0 / (len(my_out) + 1)
        stage = f"join-{j}-{token}"
        try:
            for jj in my_out:
                _ensure_peer(jj)
            # fence: nothing of ours may be in flight while the grown
            # member set measures its baseline
            for jj in sorted(k for k in peers if k in members - dead):
                peers[jj].flush(cfg.barrier_timeout_s)
            barrier.wait(stage, timeout_s=cfg.barrier_timeout_s)
            baseline_mass = _mass_rendezvous(stage)
        except (RuntimeError, TimeoutError, OSError, ValueError) as e:
            baseline_mass = None
            exact = False
            _log.warn("rank %d: join rendezvous %r degraded (%s: %s); "
                      "continuing without an exact baseline", rank, stage,
                      type(e).__name__, e)
        _mt.set("bf_peer_state", float(_res.HEALTHY), peer=f"rank{j}")
        _bb.record("peer_admitted", peer=f"rank{j}", rank=rank, step=steps,
                   exact=exact)

    def _release_leaver(j: int, token: str) -> None:
        """A ``leaving.<j>`` record appeared: fence our stream to the
        leaver (all our deposits applied), meet at its leave barrier
        (after which nothing is in flight toward it), and wait at the
        ``-fin`` barrier for its mass handoff to land.  The baseline is
        unchanged: the leaver's mass moved into member windows."""
        nonlocal my_out, frac, exact
        stage = f"leave-{j}-{token}"
        _bb.record("peer_leaving", peer=f"rank{j}", rank=rank, step=steps)
        try:
            h = peers.get(j)
            if h is not None:
                h.flush(cfg.barrier_timeout_s)
            barrier.wait(stage, timeout_s=cfg.barrier_timeout_s)
            # the leaver drains its window and hands its mass off
            # between these two barriers
            barrier.wait(stage + "-fin", timeout_s=cfg.barrier_timeout_s)
        except (RuntimeError, TimeoutError, OSError) as e:
            exact = False
            _log.warn("rank %d: leave rendezvous %r degraded (%s: %s)",
                      rank, stage, type(e).__name__, e)
        members.discard(j)
        left.add(j)
        barrier.exclude.add(j)
        peers.pop(j, None)  # the caller's finally closes it
        _mt.set("bf_peer_state", float(_res.LEFT), peer=f"rank{j}")
        _bb.record("peer_leave", peer=f"rank{j}", rank=rank, step=steps,
                   exact=exact)
        plan = _make_plan()
        my_out = list(plan.out_neighbors(rank))
        frac = 1.0 / (len(my_out) + 1)

    def _poll_membership() -> bool:
        """Handle membership records at a round boundary (leaves first:
        their rendezvous must not race an admission), then report whether
        a member finished the run (the global end for joiners whose own
        duration clock started late)."""
        mview = _mship.scan(barrier.path, n)
        for j, token in sorted(mview.leaving.items()):
            if j == rank or j in left or j in dead or j not in members:
                continue
            if ("leaving", j, token) in handled:
                continue
            handled.add(("leaving", j, token))
            _release_leaver(j, token)
        for j, token in sorted(mview.announced.items()):
            if j == rank or j in members:
                continue
            if ("member", j, token) in handled:
                continue
            handled.add(("member", j, token))
            _admit_joiner(j, token)
        for m in sorted(members - dead):
            if m != rank and os.path.exists(
                    os.path.join(barrier.path, f"stopped.{m}")):
                return True
        return False

    def _graceful_leave() -> None:
        """This rank's graceful drain: fence own streams, announce the
        intent, wait for every member to fence theirs (the leave barrier:
        nothing in flight toward this window afterwards), drain the
        window, hand the whole (x, p) to live out-neighbours in
        drain-flagged deposits, record ``left``, and confirm at the
        ``-fin`` barrier so the members know the handoff landed."""
        nonlocal x, p
        token = _mship.new_token()
        stage = f"leave-{rank}-{token}"
        _bb.record("leave_begin", rank=rank, step=steps)
        # our regular deposits must be applied before the members fence
        for jj in sorted(k for k in peers if k in members - dead):
            peers[jj].flush(cfg.barrier_timeout_s)
        _mship.write_record(barrier.path, "leaving", rank, token)
        barrier.wait(stage, timeout_s=cfg.barrier_timeout_s)
        # every member fenced its stream to us before entering the
        # barrier: nothing is in flight toward this window any more.  The
        # harvester retires first; its staged take joins the handoff
        if db is not None:
            p = _fold(db.close(), x, p)
        p = _take_and_fold(win, my_slots, x, p, payload)
        live = sorted((members - dead) - {rank})
        plan = _make_plan()
        tgt = [j for j in plan.out_neighbors(rank) if j in live] or live
        if not tgt:
            raise RuntimeError("graceful leave with no live member to "
                               "hand push-sum mass to")
        share = np.empty(d + 1, np.float64)
        share[:-1] = x
        share[-1] = p
        share /= float(len(tgt))
        for j in tgt:
            _ensure_peer(j).deposit_async(rank, share, accumulate=True,
                                          drain=True)
        for j in tgt:
            peers[j].flush(cfg.barrier_timeout_s)  # the handoff applied
        x[:] = 0.0
        p = 0.0
        win.set_self(np.zeros(d + 1))
        _mship.write_record(barrier.path, "left", rank, token)
        _mship.clear_record(barrier.path, "leaving", rank)
        barrier.wait(stage + "-fin", timeout_s=cfg.barrier_timeout_s)
        _mt.inc("bf_leaves_total", 1.0)
        _bb.record("leave_done", rank=rank, handed_to=tgt, step=steps)

    def _wait_resilient(stage: str) -> None:
        """A barrier that learns its exclusion set: when ranks die between
        the loop's detection window and a rendezvous, the timeout names
        them and the survivors stop waiting for corpses.  Past the
        rendezvous protocol there is no rebase, so exactness is off."""
        nonlocal exact
        if cfg is None:
            barrier.wait(stage)
            return
        try:
            barrier.wait(stage, timeout_s=cfg.barrier_timeout_s)
        except TimeoutError:
            missing = {r2 for r2 in range(n)
                       if r2 not in barrier.exclude and not os.path.exists(
                           os.path.join(barrier.path, f"{stage}.{r2}"))}
            if not missing:
                raise
            for j in sorted(missing):
                _tombstone(j)
            dead.update(missing)
            barrier.exclude |= missing
            for j in missing:
                peers.pop(j, None)
            exact = False
            barrier.wait(stage, timeout_s=cfg.barrier_timeout_s)

    # ---------------------------------------------------------- startup
    if join:
        # the job is already running: the startup barriers are history.
        # Clear records of this rank's previous life, publish our window
        # address, and discover the roster from the records
        for kind in ("dead", "left", "leaving", "member"):
            _mship.clear_record(barrier.path, kind, rank)
        transport.publish(barrier, rank)
        # the roster is rank 0's record of the initial members, written
        # once they all passed the "created" barrier, plus the admitted
        # joiners, minus tombstones and completed leavers.  (The JAX
        # package reads the roster off the window-address files alone; a
        # member that published late, as on a loaded host, is then missing
        # from the joiner's set, and the joiner neither reaches rank 0's
        # meta window nor waits for that member at its rendezvous.)
        roster_deadline = time.perf_counter() + cfg.barrier_timeout_s
        while True:
            initial = _read_roster(barrier.path)
            mview = _mship.scan(barrier.path, n)
            if initial is not None:
                members = ((initial | set(mview.announced)) - mview.dead
                           - set(mview.left) - {rank})
                if members:
                    break
            if time.perf_counter() > roster_deadline:
                raise RuntimeError(
                    f"joiner rank {rank} found no live member records "
                    f"in {barrier.path} within {cfg.barrier_timeout_s}s "
                    "(is the job elastic, started with initial_members=?)")
            time.sleep(0.05)
        transport.collect(barrier, sorted(members))
        meta = open_window(0, f"{name}:meta", n, 2)
        barrier.exclude = set(range(n)) - members - {rank}
        # warm start from a member's window: one read_self of its
        # published (x, p), round-consistent by construction (published
        # under the window's self mutex).  No checkpoint file is read.
        z = src = None
        t_ws = time.perf_counter()
        ws_deadline = t_ws + cfg.barrier_timeout_s
        while z is None and time.perf_counter() < ws_deadline:
            for nb in sorted(members):
                try:
                    s = _ensure_peer(nb).read_self()
                except (RuntimeError, OSError, ConnectionError):
                    continue
                if s[-1] > 0.0:
                    z = s[:-1] / s[-1]
                    src = nb
                    break
            if z is None:
                time.sleep(0.01)
        if z is None:
            raise RuntimeError(
                f"joiner rank {rank} could not warm-start: no member "
                "published an (x, p) window snapshot within "
                f"{cfg.barrier_timeout_s}s (was the job started elastic, "
                "with initial_members=, so members publish?)")
        x = np.asarray(z, np.float64).copy()
        p = 1.0  # a fresh push-sum weight: mass enters the system here
        warm_s = time.perf_counter() - t_ws
        _mt.observe("bf_join_warmstart_seconds", warm_s)
        _bb.record("join_warmstart", rank=rank, source=src,
                   warmstart_s=round(warm_s, 6))
        # announce, then meet the members at the admission rendezvous
        token = _mship.new_token()
        members.add(rank)
        ever_joined.add(rank)
        _mship.write_record(barrier.path, "member", rank, token)
        stage = f"join-{rank}-{token}"
        try:
            # wait in short slices, re-scanning the records between them:
            # a member the joiner discovered can drain (or die) before it
            # ever polls this join record
            deadline = time.perf_counter() + cfg.barrier_timeout_s
            while True:
                try:
                    barrier.wait(stage, timeout_s=min(
                        2.0, max(0.1, deadline - time.perf_counter())))
                    break
                except TimeoutError:
                    if time.perf_counter() >= deadline:
                        raise
                    mv = _mship.scan(barrier.path, n)
                    gone = (mv.dead | set(mv.left)) & members - {rank}
                    if gone:
                        members -= gone
                        barrier.exclude |= gone
            baseline_mass = _mass_rendezvous(stage)
        except (TimeoutError, OSError, ValueError) as e:
            baseline_mass = None
            exact = False
            _log.warn("rank %d: own join rendezvous degraded (%s: %s); "
                      "continuing without an exact baseline",
                      rank, type(e).__name__, e)
        plan = _make_plan()
        my_out = list(plan.out_neighbors(rank))
        frac = 1.0 / (len(my_out) + 1)
        for j in my_out:
            _ensure_peer(j)
    else:
        if rank == 0:
            # per-rank (steps, last loss) land here, so the report carries
            # every rank's step count across the process boundary
            meta = create_window(f"{name}:meta", n, 2)
        transport.publish(barrier, rank)
        barrier.exclude |= set(range(n)) - members
        barrier.wait("created")
        if elastic and rank == 0:
            _write_roster(barrier.path, members)
        transport.collect(barrier, sorted(members))
        if rank != 0:
            meta = open_window(0, f"{name}:meta", n, 2)
        if elastic:
            # every initial member starts with p = 1, so the baseline is
            # exact by construction; admissions re-measure it
            baseline_mass = float(len(members))
        plan = (_make_plan() if (elastic or ctl is not None)
                else topology)
        my_out = list(plan.out_neighbors(rank))
        frac = 1.0 / (len(my_out) + 1)
        for j in my_out:
            _ensure_peer(j)

    def _publish_self() -> None:
        self_buf[:-1] = x
        self_buf[-1] = p
        win.set_self(self_buf)

    def _end_round(loss, ta: float) -> None:
        """The round's recorder end and ``optimizer_step``, and its wall
        clock from the boundary as ``bf_round_seconds``."""
        if rec is not None:
            rec.end("collective", key=("async_dsgd_mp", rank, steps),
                    op="async_dsgd_round", cid="async_dsgd_round",
                    step=steps, rank=rank)
            rec.record("optimizer_step", step=steps, rank=rank,
                       loss=float(loss))
        _mt.observe("bf_round_seconds", time.perf_counter() - ta,
                    rank=str(rank))

    if elastic:
        # the initial snapshot, so a joiner can warm-start even before
        # this rank's first full round lands
        _publish_self()

    t0 = time.perf_counter()
    with _stream_context(packer):
        while (time.perf_counter() - t0 < duration_s
               and (stop_after_steps is None or steps < stop_after_steps)):
            try:
                _chaos.check_step(rank, steps)
            except _chaos.ChaosLeave:
                _graceful_leave()
                return None
            if (elastic and leave_after_s is not None
                    and time.perf_counter() - t0 >= leave_after_s):
                _graceful_leave()
                return None
            if cfg is not None and steps % 16 == 0:
                # throttled: n - 1 stat() calls against a possibly remote
                # barrier directory have no place on every round; 16
                # rounds add tens of ms to a detection deadline dominated
                # by the reconnect budget (the deposit failure path below
                # detects independently)
                newly = _tombstoned()
                if newly:
                    _heal_and_rebase(newly)
                if elastic and _poll_membership():
                    break  # a member finished: meet at the stop barrier
            if ctl is not None and steps > 0 \
                    and steps % control.evidence_every == 0:
                with _tr.span("control", "dsgd", round_=steps):
                    _ctl_round_boundary()
            if retune is not None and steps > 0 and steps % 16 == 0:
                # the transport autotune at this round boundary, at the
                # tombstone poll's cadence (the no-change case is a pure
                # function call a peer)
                with _tr.span("control", "dsgd", round_=steps):
                    retune(steps)
            trec = _tr.get()
            if trec is not None:
                t_rnd_w = time.time()
            if rec is not None:
                rec.begin("collective", key=("async_dsgd_mp", rank, steps),
                          op="async_dsgd_round", cid="async_dsgd_round",
                          step=steps, rank=rank, peers=my_out)
            ta = time.perf_counter()
            # the disagreement observation feeds the control evidence
            watch = _Disagreement(x, p) if ctl is not None else None
            ov = None
            with _tr.span("gossip", "dsgd", round_=steps):
                if db is not None:
                    # overlapped gossip-IN: apply the mass harvested under
                    # the previous round's compute, then re-arm it
                    staged, hidden = db.apply_staged()
                    p = _fold(staged, x, p, watch)
                    tot = hidden + (time.perf_counter() - ta)
                    ov = hidden / tot if tot > 0 else 0.0
                    _mt.set("bf_overlap_fraction", ov, rank=str(rank))
                    db.begin()
                    ph["harvest"] += hidden
                else:
                    p = _take_and_fold(win, my_slots, x, p, payload,
                                       watch)
            if watch is not None and watch.value is not None:
                ctl.note_disagreement(watch.value)
            if elastic:
                # a coherent (x, p): what a joining peer warm-starts from
                _publish_self()
            tb = time.perf_counter()
            tree = packer.unpack(np.divide(x, p, out=zbuf))
            tc = time.perf_counter()
            with _tr.span("compute", "dsgd", round_=steps):
                loss, grads = loss_and_grad(rank, steps, tree)
            losses.append(float(loss))
            td = time.perf_counter()
            packer.pack(grads, out=gvec)
            gvec *= lr * p
            x -= gvec
            te = time.perf_counter()
            if ctl is not None and steps % gossip_every != 0:
                # the plan's local-SGD cadence: a step that does not
                # gossip keeps the whole (x, p) local; no split, no
                # deposits, mass trivially conserved
                ph["consume"] += tb - ta
                ph["unpack"] += tc - tb
                ph["loss_and_grad"] += td - tc
                ph["pack"] += te - td
                _end_round(loss, ta)
                if trec is not None:
                    _emit_round(trec, t_rnd_w, ta, steps, ov)
                steps += 1
                if skew_s > 0 or poll_interval_s > 0:
                    time.sleep(skew_s + poll_interval_s)
                continue
            payload[:-1] = x
            payload[-1] = p
            payload *= frac
            failed: List[int] = []
            withheld = 0
            # gossip-OUT under the round's span: deposit_async captures the
            # thread-local (trace_id, span_id, round) here, so every wire
            # frame this round sends is causally stamped
            with _tr.span("gossip", "dsgd", round_=steps):
                for j in my_out:
                    if cfg is not None:
                        try:
                            # a replan can add an edge never opened
                            # before, and the peer may have died since:
                            # an open failure is peer evidence, not a crash
                            h = _ensure_peer(j).health
                        except (RuntimeError, TimeoutError, OSError):
                            failed.append(j)
                            continue
                        if h is not None:
                            state = h.poll()
                            if state == _res.REJOINED:
                                # the stream reconnected to a peer we had
                                # given up on mid-round: re-admit at this
                                # round boundary and resume sending
                                h.admit()
                                state = _res.HEALTHY
                            if state == _res.DEAD:
                                failed.append(j)
                                continue
                            if state != _res.HEALTHY:
                                # SUSPECT: withhold this peer's share
                                # instead of bleeding mass into a possible
                                # corpse; any row-stochastic split is
                                # unbiased under the push-sum weight
                                withheld += 1
                                continue
                    # fire-and-forget on the pipelined transport: the
                    # payload is snapshotted at enqueue, so its reuse is
                    # safe
                    try:
                        _ensure_peer(j).deposit_async(_slot_in(j), payload,
                                                      accumulate=True)
                    except (RuntimeError, TimeoutError, OSError):
                        if cfg is None:
                            raise
                        failed.append(j)
            x *= frac
            p *= frac
            if failed or withheld:
                # undelivered shares stay ours: mass never evaporates at a
                # dead peer's doorstep
                for _ in range(len(failed) + withheld):
                    x += payload[:-1]
                    p += payload[-1]
            if failed:
                _heal_and_rebase(set(failed))
            tf = time.perf_counter()
            if snapshot_every and steps % snapshot_every == 0:
                # serve-while-training publish: the retained post-step
                # (x, p) (z = x / p is invariant to the frac split),
                # swapped in atomically under its round stamp
                with _tr.span("publish", "dsgd", round_=steps):
                    _snapshots.table().publish(
                        f"{name}:{rank}", steps,
                        {"x": x, "p": np.array([p]),
                         "round": np.array([float(steps)])})
                ph["publish"] += time.perf_counter() - tf
            ph["consume"] += tb - ta
            ph["unpack"] += tc - tb
            ph["loss_and_grad"] += td - tc
            ph["pack"] += te - td
            ph["deposit"] += tf - te
            _end_round(loss, ta)
            if trec is not None:
                _emit_round(trec, t_rnd_w, ta, steps, ov)
            steps += 1
            if skew_s > 0 or poll_interval_s > 0:
                time.sleep(skew_s + poll_interval_s)
    # fence before the audit barrier: every pipelined deposit must be
    # acknowledged as applied before this rank declares "I deposit no
    # more", or in-flight mass would land after the owners' final drain
    final_failed: set = set()
    for j, h in sorted(peers.items()):
        try:
            h.flush()
        except (RuntimeError, TimeoutError, OSError):
            if cfg is None:
                raise
            final_failed.add(j)
    if final_failed:
        # a peer died after the last detection window: too late for a
        # rebase rendezvous, so the exactness claim is withdrawn
        for j in sorted(final_failed):
            _tombstone(j)
        dead.update(final_failed)
        barrier.exclude |= final_failed
        for j in final_failed:
            peers.pop(j, None)
        exact = False
    wire_bytes = transport.wire_bytes()
    stats = transport.stream_stats()
    if stats:
        # every rank's wire bookkeeping reaches the report through the
        # barrier directory (the other ranks' streams are the ones that
        # see a faulty peer's server)
        spath = os.path.join(barrier.path, f"streams.{rank}")
        with open(spath + ".tmp", "w") as f:
            json.dump(stats, f)
        os.replace(spath + ".tmp", spath)
    # no rank deposits after this barrier, so the drain below is exact
    _wait_resilient("stopped")
    wall = time.perf_counter() - t0
    if db is not None:
        # the harvester's staged take is mass this rank owns
        p = _fold(db.close(), x, p)
    p = _take_and_fold(win, my_slots, x, p, payload)
    win.set_self(np.concatenate([x, [p]]))
    meta.deposit(rank, np.array([steps, losses[-1] if losses else 0.0]),
                 accumulate=False)
    _wait_resilient("done")

    report = None
    if rank == 0:
        wins = {rank: win}
        wins.update(peers)
        alive = sorted(members - dead)
        for r in alive:
            if r not in wins:
                wins[r] = open_window(r, f"{name}:{r}", _peer_slots(r),
                                      d + 1)
        total_mass = 0.0
        zs = np.empty((len(alive), d))
        for i, r in enumerate(alive):
            s = wins[r].read_self()
            zs[i] = s[:-1] / s[-1]
            total_mass += float(s[-1])
            for k in range(wins[r].n_slots):
                buf, fresh = wins[r].read(k, consume=False)
                if fresh > 0:
                    total_mass += float(buf[-1])
        steps_all = [int(meta.read(r, consume=False)[0][0])
                     for r in range(n)]
        all_losses: List[List[float]] = [[] for _ in range(n)]
        all_losses[rank] = losses
        all_phases: List[Dict[str, float]] = [{} for _ in range(n)]
        all_phases[rank] = ph
        finals: list = [None] * n
        for i, r in enumerate(alive):
            finals[r] = packer.unpack(zs[i])
        stream_stats = {}
        for r in alive:
            try:
                with open(os.path.join(barrier.path, f"streams.{r}")) as f:
                    stream_stats[r] = json.load(f)
            except (OSError, ValueError):
                continue  # the shm transport keeps none
        report = DSGDReport(
            wall_time_s=wall,
            steps_per_rank=steps_all,
            losses=all_losses,
            final_params=finals,
            total_mass=total_mass,
            consensus_gap=float(np.abs(zs - zs.mean(axis=0)).max()),
            phase_s=all_phases,
            dead_ranks=sorted(dead),
            baseline_mass=baseline_mass if exact else None,
            left_ranks=sorted(left),
            joined_ranks=sorted(ever_joined),
            wire_bytes=wire_bytes,
            stream_stats=stream_stats,
            control_plan=ctl.plan if ctl is not None else None,
            plan_changes=ctl.plan_changes if ctl is not None else 0,
        )
    # owners unlink only after the audit has read every segment (the
    # caller's finally frees everything this process opened)
    _wait_resilient("audited")
    return report


class AsyncWinPutOptimizer:
    """The host-side runner behind
    ``DistributedWinPutOptimizer(..., async_=True)``.

    The asynchronous mode cannot live inside one synchronous step: its
    point is that ranks do not share a step counter.  This object runs the
    rank loops on the host runtime (:func:`run_async_dsgd`), while each
    rank's gradient work runs on the card (its own CUDA stream per rank
    thread).

    Usage::

        opt = DistributedWinPutOptimizer(base, topology=topo, async_=True,
                                         lr=0.05)
        report = opt.run(params0, loss_and_grad, duration_s=5.0)
    """

    def __init__(self, topology: Topology, *, lr: float,
                 name: str = "winput_async"):
        self.topology = topology
        self.lr = lr
        self.name = name

    def run(self, params0, loss_and_grad, *, duration_s: float = 5.0,
            skew: Optional[Sequence[float]] = None, overlap: bool = False,
            stop_after_steps: Optional[int] = None) -> DSGDReport:
        return run_async_dsgd(
            self.topology, params0, loss_and_grad, lr=self.lr,
            duration_s=duration_s, skew=skew, name=self.name,
            overlap=overlap, stop_after_steps=stop_after_steps)
