"""Rows across processes: the transport of a context that spans processes.

Counterpart of the exchange half of ``bluefog_tpu/ops/pallas_gossip.py::
_make_exchange_kernel`` (:307-385: the barrier handshake, one remote DMA a
slot, ``wait_recv`` and ``wait_send``) and of the ``ppermute`` of
``bluefog_tpu/ops/collectives.py``.  When ``init`` runs in a process group of
``P`` processes, every rank-stacked tensor a collective sees is the process's
*owned block*: for a schedule of ``S`` rows, process ``p`` holds rows
``[p S/P, (p+1) S/P)``.  A gossip slot's source row may then live in another
process; this module brings each owned rank the rows it reads.

Two forms, chosen by the tensor's device, with no fallback between them:

- **CPU**: gloo ``isend``/``irecv``.  Each process sends a peer only the
  rows of its block that some rank of the peer reads (``recv_src`` names
  them), as the ``ppermute`` moves only what an edge needs.
- **CUDA: peer memory.**  Each process allocates *symmetric buffers* once
  (``cudaMalloc`` outside PyTorch's caching allocator, in the kernel
  library) and shares their IPC handles over gloo; every process maps every
  peer's buffers.  On one card the processes share it through CUDA IPC; on
  a multi-GPU node the same addresses are NVLink peer reads.  K1's peer form
  (:func:`~bluefog_tpu_torch.ops.gossip_kernel.gossip_mix_peer`) reads its
  source rows straight from the peers' buffers, and K2's
  (:func:`~bluefog_tpu_torch.ops.deliver_kernel.window_deliver_peer`) stores
  into the peers' landing buffers.

The CUDA form orders the processes with interprocess CUDA events and never
with a flag that device code spins on: kernels of processes that share a
card time-slice, so a spin could stall for whole slices or deadlock.  An
event is bound by ``cudaStreamWaitEvent`` to the record issued *before* the
call, so a host barrier between the records and the waits tells each
process that its peers have issued theirs.  CUDA IPC joins processes of one
host only, so that barrier is a sequence number per process in a small
shared file (:class:`_HostSeq`): a process arrives by writing its call
count and waits until every count reaches it, in microseconds where a gloo
barrier over loopback TCP took a millisecond or more.

- A gossip call (:meth:`Transport.exchange`) finds each payload in a
  staged buffer (laid there by :meth:`Transport.pack`, or copied there),
  records "ready", passes one barrier, waits on the peers' "ready", runs
  its kernels, and records "done".  Staged buffers come in
  two, used by call parity: a call packs into the buffer whose last readers
  were the call before the previous one, and waits on their "done" first.
  Every peer issued that "done" before it reached the previous call's
  barrier, which this process has passed, so no pack overwrites rows a slow
  peer still reads (the TPU kernel's ``wait_send``).
- A window (:class:`WindowLinks`) has one set of landing buffers, which
  persist.  A put or accumulate passes a barrier, waits on the peers'
  "consumed" (their last ``win_update`` finished reading), stores, and
  records "delivered"; ``win_update`` passes a barrier, waits on the peers'
  "delivered", merges, and records "consumed".

The staged buffers live until :func:`bluefog_tpu_torch.shutdown`, a
window's landing buffers until ``win_free`` (:meth:`Transport.release`);
both close the mappings and free the memory (a collective).  Since they are
not PyTorch allocations, ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``,
which stops PyTorch from sharing its own blocks by IPC, does not affect
them.

What the transport derives from a schedule (the CPU form's send and receive
lists, the card's address tables) is cached by the schedule object, weakly:
a schedule made per call (an aperiodic matrix, a pairing) takes its entries
with it when its own cache drops it.  Payloads of any dtype travel, integer
ones included (``top_k``'s indices).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import os
import socket
import tempfile
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bluefog_tpu_torch.topology.schedule import GossipSchedule

__all__ = ["Transport", "PeerRows", "PeerTargets", "WindowLinks", "active",
           "activate", "owned_rows", "owned_start", "peer_rows",
           "peer_targets"]

_ACTIVE: Optional["Transport"] = None


def active() -> Optional["Transport"]:
    """The transport of the context, when it spans processes; else None."""
    return _ACTIVE


def activate(transport: Optional["Transport"]) -> None:
    global _ACTIVE
    _ACTIVE = transport


def owned_rows(total: int) -> int:
    """Rows of a ``total``-row schedule this process holds: all of them in
    one process, ``total / P`` in a context over ``P`` processes."""
    return total if _ACTIVE is None else _ACTIVE.rows(total)


def owned_start(total: int) -> int:
    """The first row of a ``total``-row schedule this process holds."""
    return 0 if _ACTIVE is None else _ACTIVE.start(total)


# ---------------------------------------------------------------------------
# What the kernels read: per owned rank and slot, a row, wherever it lives
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PeerRows:
    """The rows owned rank ``i`` reads in slot ``k``: ``views[i][k]``, a
    ``(L,)`` tensor (in this process's memory, or a peer's mapped here), or
    None where the slot has no edge.  ``ptrs``, on the card, is the same
    table as an ``(m, K)`` int64 tensor of device addresses (0: no edge),
    which K1's peer form reads; ``aligned`` says whether every address is
    16-byte aligned."""

    views: List[List[Optional[torch.Tensor]]]
    length: int
    dtype: torch.dtype
    ptrs: Optional[torch.Tensor] = None
    aligned: bool = False

    @property
    def num_slots(self) -> int:
        return len(self.views[0]) if self.views else 0

    def valid(self, device) -> torch.Tensor:
        """``(m, K)`` bool: the slots with an edge."""
        return torch.tensor([[v is not None for v in row]
                             for row in self.views], dtype=torch.bool,
                            device=device).reshape(len(self.views),
                                                   self.num_slots)

    def gather(self, device) -> torch.Tensor:
        """The rows as one ``(m, K, L)`` tensor, zeros where no edge."""
        out = torch.zeros(len(self.views), self.num_slots, self.length,
                          dtype=self.dtype, device=device)
        for i, row in enumerate(self.views):
            for k, v in enumerate(row):
                if v is not None:
                    out[i, k].copy_(v)
        return out


@dataclasses.dataclass
class PeerTargets:
    """Where this process's payload lands: delivery ``d`` stores owned
    payload row ``src_rows[d]`` into the landing slot ``views[d]`` (a
    ``(L,)`` tensor in this process's window or a peer's mapped here).  On
    the card ``dsts`` holds the same slots as device addresses and
    ``src_index`` the rows, for K2's peer form."""

    views: List[torch.Tensor]
    src_rows: List[int]
    length: int
    dtype: torch.dtype
    dsts: Optional[torch.Tensor] = None
    src_index: Optional[torch.Tensor] = None
    aligned: bool = False


def _aligned(ts: Sequence[torch.Tensor]) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def peer_rows(sched: GossipSchedule, start: int,
              blocks: Sequence[torch.Tensor]) -> PeerRows:
    """The :class:`PeerRows` of the ranks ``[start, start + m)`` of
    ``sched``, with process ``q``'s ``(m, L)`` block at ``blocks[q]`` (its
    rows in this process's memory or mapped here).  On the card the address
    table is built too."""
    m, length = blocks[0].shape
    src = sched.recv_src[start:start + m, :sched.num_slots]
    views: List[List[Optional[torch.Tensor]]] = []
    for i in range(m):
        row = []
        for j in src[i]:
            j = int(j)
            row.append(None if j < 0 else blocks[j // m][j % m])
        views.append(row)
    out = PeerRows(views, length, blocks[0].dtype)
    if blocks[0].device.type == "cuda":
        live = [v for row in views for v in row if v is not None]
        out.ptrs = torch.tensor(
            [[0 if v is None else v.data_ptr() for v in row] for row in views],
            dtype=torch.int64).reshape(m, len(src[0]) if m else 0).to(
                blocks[0].device)
        out.aligned = _aligned(live)
    return out


def peer_targets(sched: GossipSchedule, start: int,
                 landings: Sequence[torch.Tensor],
                 mask: Optional[np.ndarray] = None) -> PeerTargets:
    """The :class:`PeerTargets` of the payload rows ``[start, start + m)``
    of ``sched``: every live slot ``(i, k)`` whose source is an owned row,
    with process ``q``'s ``(m, K, L)`` landing buffers at ``landings[q]``.
    ``mask`` (``(S, K)``, default ``recv_src >= 0``) selects the live
    slots."""
    m, k, length = landings[0].shape
    src = sched.recv_src[:, :sched.num_slots]
    live = src >= 0 if mask is None else (mask != 0) & (src >= 0)
    views, rows = [], []
    for i in range(src.shape[0]):
        for slot in range(k):
            j = int(src[i, slot])
            if live[i, slot] and start <= j < start + m:
                views.append(landings[i // m][i % m, slot])
                rows.append(j - start)
    out = PeerTargets(views, rows, length, landings[0].dtype)
    if landings[0].device.type == "cuda" and views:
        dev = landings[0].device
        out.dsts = torch.tensor([v.data_ptr() for v in views],
                                dtype=torch.int64).to(dev)
        out.src_index = torch.tensor(rows, dtype=torch.int32).to(dev)
        out.aligned = _aligned(views)
    return out


# ---------------------------------------------------------------------------
# Peer memory on the card: symmetric buffers and interprocess events
# ---------------------------------------------------------------------------


class _DeviceBytes:
    """A device address as ``__cuda_array_interface__``, so that
    ``torch.as_tensor`` views memory PyTorch did not allocate."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2, "strides": None}


def _lib_call(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


class _Arena:
    """One symmetric allocation: ``nbytes`` in every process of the group,
    each process's mapped into every other.  Made collectively."""

    def __init__(self, tr: "Transport", nbytes: int):
        from bluefog_tpu_torch.ops import _build

        lib = _build.load()
        self.nbytes = max(int(nbytes), 16)
        dev = tr.device.index
        ptr = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(64)
        _lib_call(lib.bf_peer_alloc(self.nbytes, dev, ctypes.byref(ptr),
                                    handle), "cudaMalloc/cudaIpcGetMemHandle")
        handles = tr.all_gather_object(handle.raw)
        self.ptrs: List[int] = []
        self._mapped: List[int] = []
        try:
            for q, h in enumerate(handles):
                if q == tr.process:
                    self.ptrs.append(ptr.value)
                    continue
                peer = ctypes.c_void_p()
                _lib_call(lib.bf_peer_open(ctypes.create_string_buffer(h, 64),
                                           dev, ctypes.byref(peer)),
                          f"cudaIpcOpenMemHandle of process {q}'s buffer")
                self.ptrs.append(peer.value)
                self._mapped.append(peer.value)
        except RuntimeError:
            for p in self._mapped:
                lib.bf_peer_close(ctypes.c_void_p(p))
            lib.bf_peer_free(ptr)
            raise
        self._own = ptr.value
        self._device = tr.device
        self._bytes = [torch.as_tensor(_DeviceBytes(p, self.nbytes),
                                       device=tr.device) for p in self.ptrs]

    def view(self, q: int, dtype: torch.dtype, shape) -> torch.Tensor:
        """Process ``q``'s buffer as a contiguous ``shape`` of ``dtype``."""
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        return self._bytes[q][:n].view(dtype).view(*shape)

    def release(self, lib) -> None:
        """Unmap the peers' buffers; the caller frees its own after every
        process has unmapped it."""
        self._bytes = []
        for p in self._mapped:
            _lib_call(lib.bf_peer_close(ctypes.c_void_p(p)),
                      "cudaIpcCloseMemHandle")
        self._mapped = []

    def free(self, lib) -> None:
        _lib_call(lib.bf_peer_free(ctypes.c_void_p(self._own)), "cudaFree")


class _Signal:
    """One interprocess CUDA event per process, each opened in every other:
    :meth:`record` marks this process's current stream, :meth:`wait` makes
    it wait for every peer's record issued before the call."""

    def __init__(self, tr: "Transport"):
        self._device = tr.device
        self.own = torch.cuda.Event(interprocess=True)
        handles = tr.all_gather_object(self.own.ipc_handle())
        self.peers = [torch.cuda.Event.from_ipc_handle(tr.device, h)
                      for q, h in enumerate(handles) if q != tr.process]

    def record(self) -> None:
        self.own.record(torch.cuda.current_stream(self._device))

    def wait(self) -> None:
        stream = torch.cuda.current_stream(self._device)
        for e in self.peers:
            stream.wait_event(e)


class _HostSeq:
    """A barrier for the processes of one host: one int64 sequence number
    per process in a small file every process maps (made by process 0 and
    unlinked once all have mapped it, so nothing is left behind).
    :meth:`wait` writes this process's next count and waits until every
    count has reached it; counts only grow, so a process that runs ahead
    into the next wait never releases a slower one early."""

    def __init__(self, tr: "Transport"):
        path = None
        if tr.process == 0:
            fd, path = tempfile.mkstemp(prefix="bf-seq-")
            os.write(fd, bytes(8 * tr.processes))
            os.close(fd)
        path = tr.all_gather_object(path)[0]
        self._seq = np.memmap(path, dtype=np.int64, mode="r+",
                              shape=(tr.processes,))
        tr.barrier()
        if tr.process == 0:
            os.unlink(path)
        self._me = tr.process
        self._count = 0
        self._timeout_s = tr.timeout_s

    def wait(self) -> None:
        self._count += 1
        self._seq[self._me] = self._count
        deadline = time.monotonic() + self._timeout_s
        spins = 0
        while int(self._seq.min()) < self._count:
            spins += 1
            # yield at first, then sleep a little: a spinning process would
            # take the core a slower peer's host work needs
            time.sleep(0 if spins < 200 else 2e-5)
            if spins % 4096 == 0 and time.monotonic() > deadline:
                raise RuntimeError(
                    f"host barrier: peers still at {self._seq.tolist()} "
                    f"after {self._timeout_s:.0f} s, this process at "
                    f"{self._count}")


class _Staged:
    """A ``(rows, L)`` buffer of one dtype in every process, twice: calls
    use the two by parity (see the module docstring)."""

    def __init__(self, tr: "Transport", dtype: torch.dtype, rows: int,
                 length: int):
        esize = torch.empty((), dtype=dtype).element_size()
        self.dtype, self.shape = dtype, (rows, length)
        self.arenas = [tr.arena(rows * length * esize) for _ in range(2)]
        self.blocks = [[a.view(q, dtype, self.shape)
                        for q in range(tr.processes)] for a in self.arenas]
        self.ready = [_Signal(tr) for _ in range(2)]
        self.done = [_Signal(tr) for _ in range(2)]
        self.calls = 0
        # per schedule, its address tables for parities 0 and 1
        self._rows: "weakref.WeakKeyDictionary[GossipSchedule, list]" = (
            weakref.WeakKeyDictionary())

    @property
    def parity(self) -> int:
        return self.calls % 2

    def own(self, process: int) -> torch.Tensor:
        return self.blocks[self.parity][process]

    def rows_for(self, sched: GossipSchedule, start: int) -> PeerRows:
        tables = self._rows.setdefault(sched, [None, None])
        if tables[self.parity] is None:
            tables[self.parity] = peer_rows(sched, start,
                                            self.blocks[self.parity])
        return tables[self.parity]


@dataclasses.dataclass(eq=False)
class WindowLinks:
    """The landing buffers of one window in every process (one ``(m, K,
    L)`` buffer per dtype, and ``(m, K)`` f32 for an associated ``p``),
    mapped into each other, and the two signals that order deliveries
    against updates.  ``landing`` holds this process's own buffers."""

    landing: Dict[torch.dtype, torch.Tensor]
    blocks: Dict[torch.dtype, List[torch.Tensor]]
    p_landing: Optional[torch.Tensor]
    p_blocks: Optional[List[torch.Tensor]]
    delivered: _Signal
    consumed: _Signal
    arenas: List[_Arena] = dataclasses.field(default_factory=list)
    targets: Dict[object, PeerTargets] = dataclasses.field(
        default_factory=dict)


# ---------------------------------------------------------------------------
# The transport
# ---------------------------------------------------------------------------


class Transport:
    """Moves rows between the processes of the default process group for
    the context (see the module docstring).  ``handshake_us`` accumulates
    the host microseconds spent in the CUDA form's handshakes (records,
    the host barrier, waits) and ``handshakes`` counts them.  The CUDA form
    needs every process on one host.  ``timeout_s`` bounds every wait for
    the peers (the host barrier, :meth:`agree`)."""

    timeout_s = 600.0

    def __init__(self, device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError("the transport needs torch.distributed's "
                               "process group: initialize_cluster() first")
        self.device = torch.device(device)
        self.process = dist.get_rank()
        self.processes = dist.get_world_size()
        self.handshake_us = 0.0
        self.handshakes = 0
        self._arenas: List[_Arena] = []
        self._staged: Dict[tuple, List[_Staged]] = {}
        self._taken: Dict[tuple, int] = {}
        self._packed: Dict[int, _Staged] = {}
        self._plans: "weakref.WeakKeyDictionary[GossipSchedule, tuple]" = (
            weakref.WeakKeyDictionary())
        self._seq: Optional[_HostSeq] = None
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type == "cuda":
            hosts = set(self.all_gather_object(socket.gethostname()))
            if len(hosts) > 1:
                raise NotImplementedError(
                    f"the peer-memory transport joins processes of one host "
                    f"(CUDA IPC); these run on {sorted(hosts)}")

    # -- the block distribution ---------------------------------------------

    def rows(self, total: int) -> int:
        if total % self.processes:
            raise ValueError(f"{total} rows cannot be split evenly over "
                             f"{self.processes} processes")
        return total // self.processes

    def start(self, total: int) -> int:
        return self.process * self.rows(total)

    def all_gather_object(self, obj) -> list:
        out = [None] * self.processes
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        dist.barrier()

    def agree(self, digest: int, what: str) -> None:
        """Raise unless every process passes the same 64-bit ``digest`` (of
        ``what``).  A process that never arrives (it took another path)
        makes the others raise after :attr:`timeout_s`."""
        mine = torch.tensor([digest], dtype=torch.int64)
        parts = [torch.empty_like(mine) for _ in range(self.processes)]
        work = dist.all_gather(parts, mine, async_op=True)
        try:
            work.wait(timeout=datetime.timedelta(seconds=self.timeout_s))
        except RuntimeError as e:
            raise RuntimeError(
                f"process {self.process} waited for the other processes to "
                f"agree on {what} (digest {digest & (2**64 - 1):016x}): "
                f"{e}; every process must make the same calls") from e
        seen = [int(t) & (2**64 - 1) for t in parts]
        if len(set(seen)) > 1:
            raise ValueError(
                f"the processes disagree on {what}: digests by process "
                + ", ".join(f"{q}: {v:016x}" for q, v in enumerate(seen))
                + "; every process must pass the same value")

    def _handshake(self) -> None:
        """The host barrier between a call's records and its waits (the
        CUDA form; see :class:`_HostSeq`), timed into ``handshake_us``."""
        if self._seq is None:
            self._seq = _HostSeq(self)
        self._seq.wait()

    def _check_device(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda" and self.device.type != "cuda":
            raise ValueError(f"a CUDA tensor in a context on {self.device}")
        if t.device.type == "cuda" and t.device != self.device:
            raise ValueError(f"tensor on {t.device}, context on "
                             f"{self.device}")

    # -- the CUDA form's buffers --------------------------------------------

    def arena(self, nbytes: int) -> _Arena:
        a = _Arena(self, nbytes)
        self._arenas.append(a)
        return a

    def _take(self, dtype: torch.dtype, rows: int, length: int) -> _Staged:
        """The staged ``(rows, length)`` buffer of ``dtype`` for the open
        call's next payload of that shape (the n-th payload of one shape
        takes the n-th buffer, made collectively when first needed), once
        the peers that last read it are done."""
        key = (dtype, rows, length)
        pool = self._staged.setdefault(key, [])
        i = self._taken.get(key, 0)
        if i == len(pool):
            pool.append(_Staged(self, dtype, rows, length))
        self._taken[key] = i + 1
        st = pool[i]
        st.done[st.parity].wait()
        return st

    def pack(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """``parts`` (``(rows, L_i)``, one dtype) side by side as one
        payload.  On the card an f32 or bf16 payload is laid straight into
        a staged buffer of the open call, which the call's exchange then
        publishes as it is: the pack is the payload's one copy.  Elsewhere
        this is ``torch.cat``.  End the call with :meth:`settle`."""
        first = parts[0]
        if first.device.type != "cuda" or first.dtype not in (
                torch.float32, torch.bfloat16):
            return torch.cat(parts, dim=1)
        self._check_device(first)
        st = self._take(first.dtype, first.shape[0],
                        sum(p.shape[1] for p in parts))
        buf = torch.cat(parts, dim=1, out=st.own(self.process))
        self._packed[buf.data_ptr()] = st
        return buf

    def settle(self) -> None:
        """End the open call: buffers packed but never exchanged (a
        collective that published other payloads) are free again."""
        self._packed.clear()
        self._taken.clear()

    @contextlib.contextmanager
    def _published(self, flats: Sequence[torch.Tensor]):
        """Stage ``flats`` (a packed payload stays where it is, any other is
        copied into a staged buffer), pass the handshake, yield the staged
        buffers, and record "done" when the caller's reads are queued."""
        try:
            used: List[_Staged] = []
            for f in flats:
                st = self._packed.pop(f.data_ptr(), None)
                if st is None or (st.dtype, st.shape) != (f.dtype,
                                                          tuple(f.shape)):
                    st = self._take(f.dtype, *f.shape)
                    st.own(self.process).copy_(f)
                used.append(st)
            t0 = time.perf_counter()
            for st in used:
                st.ready[st.parity].record()
            self._handshake()
            for st in used:
                st.ready[st.parity].wait()
            self.handshake_us += (time.perf_counter() - t0) * 1e6
            self.handshakes += 1
            yield used
            for st in used:
                st.done[st.parity].record()
                st.calls += 1
        finally:
            self.settle()

    # -- the CPU form --------------------------------------------------------

    def _plan(self, sched: GossipSchedule):
        """For the CPU form: the owned rows each peer needs (``send``), the
        rows needed from each peer (``recv``), both sorted."""
        if sched not in self._plans:
            m, start = self.rows(sched.size), self.start(sched.size)
            src = sched.recv_src[:, :sched.num_slots]
            owner = lambda j: j // m  # noqa: E731
            send, recv = {}, {}
            for q in range(self.processes):
                if q == self.process:
                    continue
                theirs = src[q * m:(q + 1) * m]
                send[q] = sorted({int(j) - start for j in theirs.ravel()
                                  if j >= 0 and owner(int(j)) == self.process})
                mine = src[start:start + m]
                recv[q] = sorted({int(j) for j in mine.ravel()
                                  if j >= 0 and owner(int(j)) == q})
            self._plans[sched] = (send, recv)
        return self._plans[sched]

    def _gloo_rows(self, sched: GossipSchedule,
                   flats: Sequence[torch.Tensor]) -> List[PeerRows]:
        send, recv = self._plan(sched)
        m, start = self.rows(sched.size), self.start(sched.size)
        reqs, got = [], []
        for f in flats:
            wire = f.view(torch.int16) if f.dtype in (
                torch.bfloat16, torch.float16) else f
            mine = {}
            for q, need in recv.items():
                if need:
                    mine[q] = torch.empty(len(need), f.shape[1],
                                          dtype=wire.dtype)
                    reqs.append(dist.irecv(mine[q], src=q))
            for q, rows in send.items():
                if rows:
                    reqs.append(dist.isend(wire[rows].contiguous(), dst=q))
            got.append(mine)
        for r in reqs:
            r.wait()
        out = []
        for f, mine in zip(flats, got):
            blocks: List[Optional[torch.Tensor]] = [None] * self.processes
            blocks[self.process] = f
            for q, need in recv.items():
                # a sparse block of q's rows: only the received ones are set
                blk = f.new_zeros(m, f.shape[1])
                if need:
                    blk[[j - q * m for j in need]] = mine[q].view(f.dtype)
                blocks[q] = blk
            out.append(peer_rows(sched, start, blocks))
        return out

    # -- what the collectives call ------------------------------------------

    @contextlib.contextmanager
    def exchange(self, sched: GossipSchedule,
                 flats: Sequence[torch.Tensor]):
        """Bring the owned ranks of ``sched`` the rows they read: yields one
        :class:`PeerRows` per ``(m, L)`` payload of ``flats``.  On the card
        the payloads are staged in peer memory and the caller's kernels must
        be queued before the block ends (its exit records "done"); on the
        CPU the rows arrive over gloo."""
        for f in flats:
            self._check_device(f)
        if not flats or flats[0].device.type == "cpu":
            yield self._gloo_rows(sched, flats)
            return
        start = self.start(sched.size)
        with self._published(flats) as used:
            yield [st.rows_for(sched, start) for st in used]

    def gather_all(self, flats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every process's ``(m, L)`` block of each payload, stacked in
        process order into the ``(P m, L)`` whole, in every process."""
        for f in flats:
            self._check_device(f)
        if not flats:
            return []
        if flats[0].device.type == "cpu":
            outs = []
            for f in flats:
                wire = f.view(torch.int16) if f.dtype in (
                    torch.bfloat16, torch.float16) else f
                parts = [torch.empty_like(wire) for _ in range(self.processes)]
                dist.all_gather(parts, wire.contiguous())
                outs.append(torch.cat(parts).view(f.dtype))
            return outs
        with self._published(flats) as used:
            return [torch.cat(st.blocks[st.parity]) for st in used]

    # -- windows --------------------------------------------------------------

    def window_links(self, rows: int, slots: int,
                     lengths: Dict[torch.dtype, int],
                     with_p: bool) -> WindowLinks:
        """Allocate a window's landing buffers in peer memory (the card
        only; collective), zeroed."""
        first = len(self._arenas)
        blocks = {}
        for dt, length in lengths.items():
            esize = torch.empty((), dtype=dt).element_size()
            a = self.arena(rows * slots * length * esize)
            blocks[dt] = [a.view(q, dt, (rows, slots, length))
                          for q in range(self.processes)]
        p_blocks = None
        if with_p:
            a = self.arena(rows * slots * 4)
            p_blocks = [a.view(q, torch.float32, (rows, slots, 1))
                        for q in range(self.processes)]
        links = WindowLinks(
            {dt: b[self.process] for dt, b in blocks.items()}, blocks,
            None if p_blocks is None else p_blocks[self.process], p_blocks,
            _Signal(self), _Signal(self), arenas=self._arenas[first:])
        return links

    def window_targets(self, links: WindowLinks, sched: GossipSchedule,
                       dtype) -> PeerTargets:
        """K2's targets for the window's ``dtype`` buffers (``"p"``: the
        associated scalar), cached on the links."""
        if dtype not in links.targets:
            blocks = links.p_blocks if dtype == "p" else links.blocks[dtype]
            links.targets[dtype] = peer_targets(sched,
                                                self.start(sched.size), blocks)
        return links.targets[dtype]

    @contextlib.contextmanager
    def delivering(self, links: WindowLinks):
        """Around a put or accumulate on the card: the peers' last updates
        have finished reading before the caller's stores run, and
        "delivered" is recorded after them."""
        t0 = time.perf_counter()
        self._handshake()
        links.consumed.wait()
        self.handshake_us += (time.perf_counter() - t0) * 1e6
        self.handshakes += 1
        yield
        links.delivered.record()

    @contextlib.contextmanager
    def updating(self, links: WindowLinks):
        """Around ``win_update`` on the card: the peers' deliveries have
        landed before the caller's reads run, and "consumed" is recorded
        after them."""
        t0 = time.perf_counter()
        self._handshake()
        links.delivered.wait()
        self.handshake_us += (time.perf_counter() - t0) * 1e6
        self.handshakes += 1
        yield
        links.consumed.record()

    # -- teardown --------------------------------------------------------------

    def release(self, arenas: Sequence[_Arena]) -> None:
        """Free ``arenas``: every process unmaps its peers' buffers, then
        frees its own (collective; every process passes its arenas of the
        same allocations)."""
        if not arenas:
            return
        from bluefog_tpu_torch.ops import _build

        lib = _build.load()
        torch.cuda.synchronize(self.device)
        self.barrier()
        for a in arenas:
            a.release(lib)
        self.barrier()
        for a in arenas:
            a.free(lib)
        gone = {id(a) for a in arenas}
        self._arenas = [a for a in self._arenas if id(a) not in gone]

    def release_window(self, links: WindowLinks) -> None:
        """A window's landing buffers freed (``win_free``; collective)."""
        self.release(links.arenas)
        links.arenas = []
        links.targets.clear()

    def close(self) -> None:
        """Free all the peer memory (collective)."""
        self._staged.clear()
        self.release(list(self._arenas))
