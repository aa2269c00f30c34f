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
  per OS process over shared memory.

Deferred, each raising ``NotImplementedError`` that names its ROADMAP item:
the TCP transport, peer-fault resilience and elastic membership (Queue 1
item 9b), serve-while-training snapshots and the control plane (item 10),
the fleet health plane and the sampling profiler (item 11).  The JAX
package's calls into chaos, blackbox, metrics, tracing and lockcheck come
back with those packages (items 10-11); none of them changes a result.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.runtime import native as _native
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
        self._mu = threading.Lock()
        self._wins: Dict[str, dict] = {}

    def create(self, name, n_slots, n_elems, dtype):
        with self._mu:
            if name in self._wins:
                return -2
            self._wins[name] = {
                "self": np.zeros(n_elems, dtype),
                "self_mu": threading.Lock(),
                "slots": [{"mu": threading.Lock(),
                           "buf": np.zeros(n_elems, dtype),
                           "deposits": 0, "fresh": 0}
                          for _ in range(n_slots)],
            }
            return 0

    def _get(self, name):
        with self._mu:
            return self._wins.get(name)

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
_py_table_mu = threading.Lock()


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
        return int(v)

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
_cast_pool_mu = threading.Lock()


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


def run_async_pushsum(
    topology: Topology,
    x0: np.ndarray,
    *,
    skew: Optional[Sequence[float]] = None,
    tol: float = 1e-3,
    timeout_s: float = 30.0,
    name: str = "async_pushsum",
    poll_interval_s: float = 0.002,
    resilience=None,
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
      resilience: peer-fault tolerance, not ported yet (item 9b).
      native: ``False`` runs on the Python twin of the window table.

    A rank's step, with no barrier anywhere: consume its landing slots,
    folding the received (x, p) mass in; keep ``1/(out_deg+1)`` of its
    mass and deposit the same fraction into each out-neighbour's window
    (accumulate); publish its estimate and sleep ``skew[r]``.  A monitor
    raises the stop flag on convergence; the ranks then drain the mass
    still in flight, so ``sum(p) == n`` holds exactly.
    """
    if resilience is not None:
        raise _not_ported("resilience=", "9b",
                          "peer-fault tolerance over the window server")
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
    est_mu = threading.Lock()
    errors: List[BaseException] = []

    def rank_loop(r: int):
        x = x0[r].copy()
        p = 1.0
        try:
            frac = 1.0 / (len(out_nbrs[r]) + 1)
            while not stop.is_set():
                # 1. consume whatever landed (possibly nothing)
                for k in range(len(in_nbrs[r])):
                    buf, fresh = wins[r].read(k, consume=True)
                    if fresh > 0:
                        x += buf[:-1]
                        p += buf[-1]
                # 2. split mass outward: receivers need not be listening
                payload = np.concatenate([x * frac, [p * frac]])
                for j in out_nbrs[r]:
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
        with est_mu:
            err = float(np.abs(estimates - true_mean).max())
        # every rank must also have taken a few steps (no vacuous pass)
        if err < tol and min(steps) >= 3:
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
    # final drain (the threads are joined, so the reads race with nothing)
    total_mass = 0.0
    for r in range(n):
        total_mass += float(wins[r].read_self()[-1])
        total_mass += _landed_mass(wins[r], range(len(in_nbrs[r])))
    with est_mu:
        final_err = float(np.abs(estimates - true_mean).max())
    report = PushSumReport(
        converged=converged and final_err < 10 * tol,
        wall_time_s=wall,
        steps_per_rank=list(steps),
        estimates=estimates.copy(),
        true_mean=true_mean,
        max_abs_err=final_err,
        total_mass=total_mass,
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
    # seconds hidden under them.  Empty for the process runner.
    phase_s: List[Dict[str, float]] = field(default_factory=list)


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
        self._mu = threading.Lock()
        # _sweep_mu serialises sweeps against pause(): pause clears the arm
        # flag, then takes it, so on return no sweep runs and none starts
        self._sweep_mu = threading.Lock()
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

    def close(self) -> List[Tuple[int, np.ndarray, int]]:
        """Stop the harvester and hand back whatever is staged (slot
        order), so taken mass is never dropped.  Idempotent."""
        self._stopped = True
        self._armed.set()  # release a parked wait
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)
        with self._mu:
            return self._take()


def _fold(entries, x, p):
    """Fold staged ``(slot, payload, fresh)`` entries into ``(x, p)`` in
    their order; returns the new ``p``."""
    for _k, buf, fresh in entries:
        if fresh > 0:
            x += buf[:-1]
            p += buf[-1]
    return p


def _take_and_fold(win, slots, x, p, buf):
    """Serial gossip-IN: read each slot where deposits landed into ``buf``
    (consumed exactly once) and fold it into ``(x, p)``, in slot order;
    returns the new ``p``.  ``buf`` is scratch of the window's size."""
    for k in slots:
        if win.fresh(k) == 0:
            continue
        _, fresh = win.read(k, consume=True, out=buf)
        if fresh > 0:
            x += buf[:-1]
            p += buf[-1]
    return p


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


def _check_dsgd_args(*, resilience=None, join_at_s=None, leave_at_s=None,
                     snapshot_every=0, control=None, fleet=None,
                     profile=None) -> None:
    if resilience is not None:
        raise _not_ported("resilience=", "9b",
                          "peer-fault tolerance over the window server")
    if join_at_s is not None:
        raise _not_ported("join_at_s=", "9b", "elastic membership")
    if leave_at_s is not None:
        raise _not_ported("leave_at_s=", "9b", "elastic membership")
    if snapshot_every:
        raise _not_ported("snapshot_every > 0", "10",
                          "serve-while-training snapshots")
    if control is not None:
        raise _not_ported("control=", "10", "the communication control "
                          "plane")
    if fleet is not None:
        raise _not_ported("fleet=", "11", "the fleet health plane")
    if profile is not None:
        raise _not_ported("profile=", "11", "the sampling profiler")


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
    resilience=None,
    join_at_s=None,
    leave_at_s=None,
    snapshot_every: int = 0,
    control=None,
    stop_after_steps: Optional[int] = None,
    fleet=None,
    profile=None,
    overlap: bool = False,
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
      topology: directed graph over the rank threads.
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
      stop_after_steps: end the run (all ranks drain) as soon as any rank
        has taken this many steps.
      overlap: compute/gossip overlap through :class:`DoubleBuffer`: a
        harvester per rank consumes landed deposits while the gradient
        runs, and the staged mixing is applied at the next round boundary
        in slot order (the serial fold order).
      native: ``False`` runs on the Python twin of the window table.
      resilience, join_at_s, leave_at_s (item 9b), snapshot_every > 0,
        control (item 10), fleet, profile (item 11): not ported yet; each
        raises ``NotImplementedError``.
    """
    _check_dsgd_args(resilience=resilience, join_at_s=join_at_s,
                     leave_at_s=leave_at_s, snapshot_every=snapshot_every,
                     control=control, fleet=fleet, profile=profile)
    n = topology.size
    packer = TreePacker(params0, np.float64)
    d = packer.size

    if skew is None:
        base = 0.001
        skew = [base * (1.0 + 4.0 * r / max(n - 1, 1)) for r in range(n)]

    in_nbrs = [list(topology.in_neighbors(r)) for r in range(n)]
    out_nbrs = [list(topology.out_neighbors(r)) for r in range(n)]
    wins = _create_windows(
        name, [max(len(in_nbrs[r]), 1) for r in range(n)], d + 1,
        native=native)
    slot_of = [{src: k for k, src in enumerate(in_nbrs[r])}
               for r in range(n)]

    stop = threading.Event()
    steps = [0] * n
    losses: List[List[float]] = [[] for _ in range(n)]
    finals: list = [None] * n
    phases: List[Dict[str, float]] = [
        dict.fromkeys(("consume", "unpack", "loss_and_grad", "pack",
                       "deposit", "harvest"), 0.0) for _ in range(n)]
    errors: List[BaseException] = []
    x0 = packer.pack(params0)
    if packer.device is not None:
        # the rank threads run on their own streams: what the caller made
        # on the default stream (parameters, data) must be complete
        import torch

        torch.cuda.synchronize(packer.device)

    def rank_loop(r: int):
        p = 1.0
        # model-sized scratch, allocated once per rank
        gvec = np.empty(d, np.float64)
        zbuf = np.empty(d, np.float64)
        payload = np.empty(d + 1, np.float64)
        my_slots = range(len(in_nbrs[r]))
        my_out = out_nbrs[r]
        frac = 1.0 / (len(my_out) + 1)
        ph = phases[r]
        db = (DoubleBuffer(wins[r], list(my_slots), d + 1)
              if overlap else None)

        def consume(x, p, staged=None):
            if staged is None:
                # serial path: take the slots where mass landed, in slot
                # order, into the rank's read buffer
                return _take_and_fold(wins[r], my_slots, x, p, payload)
            # the fold of what the harvester staged under compute, in slot
            # order too: the same operations as the serial fold
            return _fold(staged, x, p)

        try:
            with _stream_context(packer):
                x = x0.copy()
                while not stop.is_set():
                    t0 = time.perf_counter()
                    if db is not None:
                        # round boundary: fold what the harvester staged
                        # under the last compute, then re-arm it
                        staged, hidden = db.apply_staged()
                        p = consume(x, p, staged)
                        db.begin()
                        ph["harvest"] += hidden
                    else:
                        p = consume(x, p)
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
                    payload[:-1] = x
                    payload[-1] = p
                    payload *= frac
                    for j in my_out:
                        wins[j].deposit(slot_of[j][r], payload,
                                        accumulate=True)
                    x *= frac
                    p *= frac
                    t5 = time.perf_counter()
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
            # run ended: drain the mass in flight so the audit is exact;
            # the harvester's staged take is mass this rank already owns
            if db is not None:
                p = consume(x, p, staged=db.close())
            p = consume(x, p)
            finals[r] = x / p
            wins[r].set_self(np.concatenate([x, [p]]))
        except BaseException as e:
            errors.append(e)
            stop.set()
        finally:
            if db is not None:
                db.close()  # idempotent; stops the harvester thread

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
    if any(t.is_alive() for t in threads):
        raise RuntimeError("async DSGD rank threads failed to stop within "
                           f"{join_budget:.1f}s; aborting without freeing")
    wall = time.perf_counter() - t0
    if errors:
        for w in wins:
            w.free()
        raise errors[0]

    total_mass = 0.0
    for r in range(n):
        total_mass += float(wins[r].read_self()[-1])
        total_mass += _landed_mass(wins[r], range(len(in_nbrs[r])))
    zs = np.stack(finals)
    report = DSGDReport(
        wall_time_s=wall,
        steps_per_rank=list(steps),
        losses=losses,
        final_params=[packer.unpack(finals[r]) for r in range(n)],
        total_mass=total_mass,
        consensus_gap=float(np.abs(zs - zs.mean(axis=0)).max()),
        phase_s=phases,
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
    """A filesystem barrier between rank processes on one host.

    The process runner needs a few rendezvous points around its training
    loop (windows created, deposits stopped, results published, audit
    done) and no collective runtime in between: a shared directory is the
    whole requirement.  Rank ``r`` touches ``<dir>/<stage>.<r>`` and waits
    until all ``n`` exist."""

    def __init__(self, path: str, n_ranks: int, rank: int):
        self.path = path
        self.n = int(n_ranks)
        self.rank = int(rank)
        os.makedirs(path, exist_ok=True)

    def wait(self, stage: str, timeout_s: float = 120.0) -> None:
        open(os.path.join(self.path, f"{stage}.{self.rank}"), "w").close()

        def missing_ranks():
            return [r for r in range(self.n)
                    if not os.path.exists(
                        os.path.join(self.path, f"{stage}.{r}"))]

        t0 = time.perf_counter()
        while missing_ranks():
            if time.perf_counter() - t0 > timeout_s:
                raise TimeoutError(
                    f"barrier {stage!r} timed out after {timeout_s:.0f}s "
                    f"on rank {self.rank}; missing rank(s) "
                    f"{missing_ranks()} (dir {self.path})")
            time.sleep(0.005)


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
    wire_codec: Optional[str] = None,
    resilience=None,
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

    Each process creates its landing window in named shared memory
    (``transport="shm"``) and deposits into its out-neighbours' windows
    directly: a cross-process ``MPI_Put`` with no receiver involvement and
    no barrier in the training loop.  ``barrier`` fires four times, all
    outside the loop: windows created, deposits stopped, results
    published, audit done.  The algorithm and its mass invariant are those
    of :func:`run_async_dsgd`; ``skew_s`` is this rank's extra sleep per
    step, ``stop_after_steps`` ends this rank's loop after that many steps
    (``duration_s`` stays the cap), and ``overlap=True`` harvests landed
    deposits under the gradient (:class:`DoubleBuffer`).  When ``params0``
    lives on the card, the gradient runs there and :class:`TreePacker`
    carries it to the shared window.

    Not ported yet, each raising ``NotImplementedError``: ``transport=
    "tcp"``/``"tcp-sync"``, ``wire_codec``, ``resilience``, ``join``,
    ``leave_after_s``, ``initial_members`` and ``stream_options`` (ROADMAP
    Queue 1 item 9b), ``snapshot_every > 0`` and ``control`` (item 10),
    ``fleet`` and ``profile`` (item 11).

    Returns a :class:`DSGDReport` on rank 0 (``losses`` filled at index
    ``rank`` only; the other ranks' curves stay in their processes), and
    ``None`` elsewhere.
    """
    if transport in ("tcp", "tcp-sync"):
        raise _not_ported(f"transport={transport!r}", "9b",
                          "the TCP window server")
    if transport != "shm":
        raise ValueError(
            f"transport must be 'shm', 'tcp' or 'tcp-sync', got "
            f"{transport!r}")
    for arg, val, what in (
            ("wire_codec=", wire_codec, "the wire codecs"),
            ("join=", join or None, "elastic membership"),
            ("leave_after_s=", leave_after_s, "elastic membership"),
            ("initial_members=", initial_members, "elastic membership"),
            ("stream_options=", stream_options, "the deposit streams")):
        if val is not None:
            raise _not_ported(arg, "9b", what)
    _check_dsgd_args(resilience=resilience, snapshot_every=snapshot_every,
                     control=control, fleet=fleet, profile=profile)
    # every window this process opens is freed in the finally: a mid-run
    # exception (loss_and_grad raising, a peer missing a barrier) must not
    # leak shm segments
    opened: List = []
    db: Optional[DoubleBuffer] = None

    def _create(wname, n_slots, n_elems):
        # each rank owns its window names, so a leftover segment can only
        # be stale (a crashed earlier run): clean it and create anew
        shm_unlink_window(wname)
        w = AsyncWindow(wname, n_slots, n_elems, np.float64, shm=True)
        opened.append(w)
        return w

    def _open(owner, wname, n_slots, n_elems):
        w = AsyncWindow(wname, attach=True)
        opened.append(w)
        return w

    try:
        d = TreePacker(params0, np.float64).size
        n_slots = max(len(list(topology.in_neighbors(rank))), 1)
        win = _create(f"{name}:{rank}", n_slots, d + 1)
        if overlap:
            # the harvester lives here, so the finally stops its thread
            # before any window is freed, on every exit path
            db = DoubleBuffer(win, list(range(n_slots)), d + 1)

        return _run_dsgd_rank_body(
            topology, rank, params0, loss_and_grad, barrier=barrier, lr=lr,
            duration_s=duration_s, skew_s=skew_s, name=name,
            poll_interval_s=poll_interval_s, win=win,
            create_window=_create, open_window=_open,
            stop_after_steps=stop_after_steps, overlap_buffer=db)
    finally:
        if db is not None:
            db.close()  # idempotent; before the windows are freed
        for w in opened:
            try:
                w.free()
            except Exception:
                pass


def _run_dsgd_rank_body(topology, rank, params0, loss_and_grad, *, barrier,
                        lr, duration_s, skew_s, name, poll_interval_s, win,
                        create_window, open_window, stop_after_steps=None,
                        overlap_buffer=None):
    n = topology.size
    packer = TreePacker(params0, np.float64)
    d = packer.size
    losses: List[float] = []
    steps = 0
    x = packer.pack(params0)
    p = 1.0
    gvec = np.empty(d, np.float64)
    zbuf = np.empty(d, np.float64)
    payload = np.empty(d + 1, np.float64)
    peers: Dict[int, object] = {}
    my_slots = range(len(list(topology.in_neighbors(rank))))
    db: Optional[DoubleBuffer] = overlap_buffer

    def _peer_slots(j: int) -> int:
        return max(len(list(topology.in_neighbors(j))), 1)

    def _slot_in(j: int) -> int:
        """Our landing slot in peer j's window."""
        return list(topology.in_neighbors(j)).index(rank)

    def _ensure_peer(j: int):
        if j not in peers:
            peers[j] = open_window(j, f"{name}:{j}", _peer_slots(j), d + 1)
        return peers[j]

    if rank == 0:
        # per-rank (steps, last loss) land here, so the report carries
        # every rank's step count across the process boundary
        meta = create_window(f"{name}:meta", n, 2)
    barrier.wait("created")
    if rank != 0:
        meta = open_window(0, f"{name}:meta", n, 2)
    my_out = list(topology.out_neighbors(rank))
    frac = 1.0 / (len(my_out) + 1)
    for j in my_out:
        _ensure_peer(j)

    t0 = time.perf_counter()
    with _stream_context(packer):
        while (time.perf_counter() - t0 < duration_s
               and (stop_after_steps is None or steps < stop_after_steps)):
            if db is not None:
                # overlapped gossip-IN: apply the mass harvested under the
                # previous round's compute, then re-arm the harvester
                staged, _ = db.apply_staged()
                p = _fold(staged, x, p)
                db.begin()
            else:
                p = _take_and_fold(win, my_slots, x, p, payload)
            loss, grads = loss_and_grad(rank, steps, packer.unpack(
                np.divide(x, p, out=zbuf)))
            losses.append(float(loss))
            packer.pack(grads, out=gvec)
            gvec *= lr * p
            x -= gvec
            payload[:-1] = x
            payload[-1] = p
            payload *= frac
            for j in my_out:
                _ensure_peer(j).deposit(_slot_in(j), payload,
                                        accumulate=True)
            x *= frac
            p *= frac
            steps += 1
            if skew_s > 0 or poll_interval_s > 0:
                time.sleep(skew_s + poll_interval_s)
    # an shm deposit has landed when it returns (the TCP transport's
    # pipelined deposits fence here first), so after this barrier no rank
    # deposits and the drain below is exact
    barrier.wait("stopped")
    wall = time.perf_counter() - t0
    if db is not None:
        # the harvester's staged take is mass this rank owns
        p = _fold(db.close(), x, p)
    p = _take_and_fold(win, my_slots, x, p, payload)
    win.set_self(np.concatenate([x, [p]]))
    meta.deposit(rank, np.array([steps, losses[-1] if losses else 0.0]),
                 accumulate=False)
    barrier.wait("done")

    report = None
    if rank == 0:
        wins = {rank: win}
        wins.update(peers)
        for r in range(n):
            if r not in wins:
                wins[r] = open_window(r, f"{name}:{r}", _peer_slots(r),
                                      d + 1)
        total_mass = 0.0
        zs = np.empty((n, d))
        for r in range(n):
            s = wins[r].read_self()
            zs[r] = s[:-1] / s[-1]
            total_mass += float(s[-1])
            total_mass += _landed_mass(wins[r], range(wins[r].n_slots))
        steps_all = [int(meta.read(r, consume=False)[0][0])
                     for r in range(n)]
        all_losses: List[List[float]] = [[] for _ in range(n)]
        all_losses[rank] = losses
        report = DSGDReport(
            wall_time_s=wall,
            steps_per_rank=steps_all,
            losses=all_losses,
            final_params=[packer.unpack(zs[r]) for r in range(n)],
            total_mass=total_mass,
            consensus_gap=float(np.abs(zs - zs.mean(axis=0)).max()),
        )
    # owners unlink only after the audit has read every segment (the
    # caller's finally frees everything this process opened)
    barrier.wait("audited")
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
