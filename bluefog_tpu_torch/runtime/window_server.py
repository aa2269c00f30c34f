"""Cross-host one-sided window transport: pipelined TCP deposits (wire v2).

Counterpart of ``bluefog_tpu/runtime/window_server.py``.  The
passive-target window story by deployment scope (upstream
``bluefog/common/mpi_controller.cc`` Win*: ``MPI_Put`` lands anywhere in
the job):

- same process / rank threads: the in-process native table
  (``csrc/windows.cc``);
- same host, separate OS processes: the named-shm backing
  (``AsyncWindow(shm=True)``);
- separate hosts: this module.  Every process can run one
  :class:`WindowServer` exposing its windows on a TCP port; peers hold a
  :class:`RemoteWindow` (synchronous, one round-trip per op) or a
  :class:`PipelinedRemoteWindow` (a per-peer background sender, the
  userspace analog of MPI's progress thread) and deposit with no receiver
  involvement beyond the server's daemon thread.

Wire protocol v2 (little-endian), byte for byte the JAX package's, so a
port client and a JAX-package server talk to each other and the other way
round.  Every frame starts ``magic u32 | op u8 | name_len u16``; per-op
bodies follow:

  0 DEPOSIT      name | slot i32, flags u8, dtype u8, n_elems i64 | payload
                 flags bit0 = accumulate, bit1 = deferred-ack (no status
                 reply; errors latch per connection until FLUSH), bit2 =
                 drain (a graceful leaver's final mass handoff, still an
                 accumulate on the table).  reply (unless deferred):
                 status i64.
  1 GET_SELF     reply status i64 | dtype u8, n_elems i64 | payload
  2 READ_SLOT    flags bit0 = consume; status carries the fresh count
  3 HELLO        name_len == 0 | version u16, features u32.  reply
                 status i64 = the granted feature mask (>= 0) or a
                 negative error (wrong version).
  4 DEPOSIT_BATCH  name_len == 0 | seq u32, count u32, then ``count``
                 items, each ``name_len u16, slot i32, flags u8, dtype u8,
                 codec u8, n_elems i64, wire_bytes i64, name,
                 payload[wire_bytes]``: one framed message for every
                 deposit bound for this peer, one ack ``seq u32 | status
                 i64`` (items applied, or the first error; per-item
                 ``wire_bytes`` keeps the stream parseable past a bad
                 item).
  5 FLUSH        name_len == 0.  reply status i64 = deposits applied on
                 this connection since the last FLUSH, or the first
                 latched deferred error (then cleared).
  6 STREAM_ATTACH  name_len == 0 | stream_id u64, epoch u32.  Binds this
                 connection to a client :class:`DepositStream` lineage:
                 the server quiesces any older-epoch connection of the
                 same stream (drains its applier), then replies status
                 i64 = the highest batch seq already applied for this
                 stream; the client drops those from its replay window
                 and re-sends only the rest, which makes reconnect replay
                 idempotent.  An epoch that is not strictly newer gets
                 ``-105``.  Requires the RESUME feature bit.
  7 HEARTBEAT    name_len == 0 | seq u32.  reply is an ACK frame
                 ``(seq | 0x80000000, 0)`` on the deposit stream's ack
                 channel.  Requires the HEARTBEAT feature bit.

  8 SNAPSHOT     group | want_round i64, count u16, then ``count`` leaf
                 names ``len u16 | name``.  reply status i64 = the round
                 (or ``-107`` round rolled, ``-108`` no snapshot), then
                 ``count u16`` and per leaf ``name_len u16, dtype u8,
                 n_elems i64 | name | payload``: every leaf from one round
                 of the served :class:`~bluefog_tpu_torch.serving.
                 snapshots.SnapshotTable`.  Requires FEATURE_SNAPSHOT.
  9 SUBSCRIBE    group | sub_id u64, epoch u32, every u32, cursor i64.
                 reply status i64 (0, ``-105`` stale epoch, ``-106`` at the
                 fan-out limit), then the connection is one-way server
                 push: frames ``round i64 (-1 = keepalive), skipped u32,
                 count u16`` and the leaves as in SNAPSHOT.  On
                 FEATURE_DELTA connections every push carries ``kind u8,
                 base_round i64`` after that header; kind 10 (DELTA)
                 frames carry per leaf ``name_len u16, dtype u8, codec u8,
                 n_elems i64, wire_bytes i64 | name | payload``, the
                 round-over-round difference (:mod:`bluefog_tpu_torch.
                 runtime.delta`).  Requires FEATURE_SUBSCRIBE.

FEATURE_TRACE (128) carries the causal trace context
(:mod:`bluefog_tpu_torch.tracing`): on a connection whose HELLO granted
it, every DEPOSIT_BATCH, FLUSH, HEARTBEAT and SNAPSHOT frame carries
``trace_id u64, span_id u64, round u32`` right after the frame header
(zeros when no span is active), batch acks grow a ``queue_us u32,
apply_us u32`` tail, and SUBSCRIBE push frames carry the header after
``_PUSH``.  A client asks for the bit only while tracing is armed, so a
stream built with tracing off sends exactly the frames it sent before.

Version negotiation is loud, never silent: a v2 server answers a v1-magic
frame with one ``status = -101`` reply and drops the connection, and
rejects any HELLO whose version is not 2 the same way.

Zero-copy discipline: clients send scatter-gather ``sendmsg`` from
memoryviews; the server receives payloads with ``recv_into`` into
per-connection reusable numpy buffers and deposits straight from them
into the window table.  Optional wire compression (f32 downcast / top-k)
lives in :mod:`bluefog_tpu_torch.runtime.wire_codec`.

The server writes into the port's native window table
(:mod:`bluefog_tpu_torch.runtime.native`), or into the Python twin when
the caller asks for it (``BLUEFOG_TPU_TORCH_NO_NATIVE=1``).

Trust model: the protocol is unauthenticated (a magic word rejects
accidental cross-talk, nothing more), the posture of the MPI/NCCL
transports it replaces.  Bind to a cluster-internal interface
(``start(host=...)``).  Malformed requests cannot corrupt or exhaust the
owner (geometry is validated against the window's shape, and claimed
lengths are bounded before any allocation), but a writer on the network
can deposit garbage values, as it can with MPI.
"""

from __future__ import annotations

import collections
import ctypes
import itertools
import os
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from bluefog_tpu_torch import chaos as _chaos
from bluefog_tpu_torch.blackbox import recorder as _bb
from bluefog_tpu_torch.metrics import comm as _mt
from bluefog_tpu_torch.metrics import registry as _mreg
from bluefog_tpu_torch.runtime import (delta as _delta, native as _native,
                                       resilience, wire_codec, wire_status)
from bluefog_tpu_torch.runtime.async_windows import (
    _DTYPES as _DTYPE_IDS, _py_windows)
from bluefog_tpu_torch.serving import snapshots as _snap
from bluefog_tpu_torch.tracing import recorder as _tr
from bluefog_tpu_torch.utils import lockcheck as _lc

__all__ = ["WindowServer", "RemoteWindow", "PipelinedRemoteWindow",
           "DepositStream", "StripedDepositStream", "stripe_of",
           "PROTOCOL_VERSION"]

_MAGIC = 0xBF_51_0E_02      # wire v2
_MAGIC_V1 = 0xBF_51_0E_01   # recognized only to reject it loudly
PROTOCOL_VERSION = wire_status.PROTOCOL_VERSION

_HDR = struct.Struct("<IBH")          # magic, op, name_len
_BODY = struct.Struct("<iBBq")        # slot, flags, dtype, n_elems
_STATUS = struct.Struct("<q")
_SELF_HDR = struct.Struct("<Bq")      # dtype, n_elems
_HELLO = struct.Struct("<HI")         # version, features
_BATCH_HDR = struct.Struct("<II")     # seq, count
_ITEM = struct.Struct("<HiBBBqq")     # name_len, slot, flags, dtype,
                                      # codec, n_elems, wire_bytes
_ACK = struct.Struct("<Iq")           # seq, status
_ATTACH = struct.Struct("<QI")        # stream_id, epoch
_HB = struct.Struct("<I")             # heartbeat seq
_HB_MARK = 0x8000_0000                # ack-frame seq bit: heartbeat reply
_SNAP_REQ = struct.Struct("<qH")      # want_round, requested-leaf count
_LEAF_NAME = struct.Struct("<H")      # one requested leaf name length
_SNAP_CNT = struct.Struct("<H")       # leaves in a snapshot reply
_SNAP_LEAF = struct.Struct("<HBq")    # name_len, dtype, n_elems
_SUB_REQ = struct.Struct("<QIIq")     # sub_id, epoch, every, cursor
_PUSH = struct.Struct("<qIH")         # round (-1 = keepalive), skipped,
                                      # leaf count
_DELTA_HDR = struct.Struct("<Bq")     # frame kind (0 full / 10 delta),
                                      # base_round: after _PUSH on every
                                      # push frame of a FEATURE_DELTA
                                      # connection, keepalives included
_DELTA_LEAF = struct.Struct("<HBBqq")  # name_len, dtype, codec, n_elems,
                                       # wire_bytes: one delta leaf entry
_TRACE_HDR = struct.Struct("<QQI")    # trace_id, span_id, round: the
                                      # wire-propagated causal context
                                      # (FEATURE_TRACE connections only)
_ACK_TIMES = struct.Struct("<II")     # queue_us, apply_us appended to
                                      # batch acks on FEATURE_TRACE
                                      # connections (never to heartbeat
                                      # acks, which keep the bit31 mark)
_OP_DEPOSIT = 0
_OP_GET_SELF = 1
_OP_READ_SLOT = 2
_OP_HELLO = 3
_OP_DEPOSIT_BATCH = 4
_OP_FLUSH = 5
_OP_STREAM_ATTACH = 6
_OP_HEARTBEAT = 7
_OP_SNAPSHOT = 8
_OP_SUBSCRIBE = 9
# not a request op: the frame-kind marker of a delta push frame on the
# SUBSCRIBE push channel (FEATURE_DELTA connections; kind 0 = full)
_OP_DELTA = 10

# client->server ops whose frames carry the trace header on FEATURE_TRACE
# connections (SUBSCRIBE propagates the other way: the server's push
# frames carry it instead)
_TRACED_OPS = frozenset((_OP_DEPOSIT_BATCH, _OP_FLUSH, _OP_HEARTBEAT,
                         _OP_SNAPSHOT))

# subscription push cadence when nothing is being published: an idle
# server must look different from a wedged one to the reader's idle
# timeout (keepalive round = -1)
_SUB_KEEPALIVE_S = 1.0
# bounds a SNAPSHOT request can claim before any allocation happens
_MAX_SNAP_LEAVES = 4096
_MAX_LEAF_NAME = 4096
# the largest dense payload one snapshot or push leaf header may claim
# before the reader allocates: a lying header must never choose the
# reader's allocation size
_MAX_LEAF_BYTES = 1 << 31

_FLAG_ACCUMULATE = 1
_FLAG_DEFERRED_ACK = 2
# bit2: this deposit is a leaver's final mass handoff (graceful drain).
# Semantically still an accumulate; the flag lets the owner tell a drain
# apart from ordinary gossip (a leaver's push-sum mass is conserved in
# the audit, a corpse's written off).  The server counts them
# (WindowServer.drain_deposits).
_FLAG_DRAIN = 4

# HELLO feature bits (the server replies with the granted intersection)
FEATURE_BATCH = 1
FEATURE_CODEC_F32 = 2
FEATURE_CODEC_TOPK = 4
FEATURE_HEARTBEAT = 8
FEATURE_RESUME = 16     # STREAM_ATTACH + idempotent reconnect replay
FEATURE_SNAPSHOT = 32   # round-stamped consistent snapshot reads (op 8)
FEATURE_SUBSCRIBE = 64  # resumable push subscriptions (op 9)
FEATURE_TRACE = 128     # wire trace context; an optional want
FEATURE_DELTA = 256     # round-over-round delta push frames (op 10)
_SERVER_FEATURES = (FEATURE_BATCH | FEATURE_CODEC_F32 | FEATURE_CODEC_TOPK
                    | FEATURE_HEARTBEAT | FEATURE_RESUME
                    | FEATURE_SNAPSHOT | FEATURE_SUBSCRIBE
                    | FEATURE_TRACE | FEATURE_DELTA)

_CODEC_FEATURE = {wire_codec.CODEC_NONE: 0,
                  wire_codec.CODEC_F32: FEATURE_CODEC_F32,
                  wire_codec.CODEC_TOPK: FEATURE_CODEC_TOPK}

# the one dtype-id table (async_windows owns np.dtype -> id; invert here)
_DTYPES = {v: k for k, v in _DTYPE_IDS.items()}

# error statuses: one registry (runtime/wire_status.py); the local _ERR_*
# names are the reference module's spelling
_ERR_GEOMETRY = wire_status.ERR_GEOMETRY
_ERR_NO_WINDOW = wire_status.ERR_NO_WINDOW
_ERR_BAD_OP = wire_status.ERR_BAD_OP
_ERR_VERSION = wire_status.ERR_VERSION
_ERR_CODEC = wire_status.ERR_CODEC
_ERR_TOO_LARGE = wire_status.ERR_TOO_LARGE
_ERR_STALE_EPOCH = wire_status.ERR_STALE_EPOCH
_ERR_BUSY = wire_status.ERR_BUSY
_ERR_ROUND_ROLLED = wire_status.ERR_ROUND_ROLLED
_ERR_NO_SNAPSHOT = wire_status.ERR_NO_SNAPSHOT

_err_text = wire_status.err_text


def _routable_host() -> str:
    """Best-effort routable address of this host for wildcard binds.
    ``gethostbyname(gethostname())`` alone is a trap: stock Debian/Ubuntu
    /etc/hosts maps the hostname to 127.0.1.1, which would advertise a
    loopback to remote peers.  The outbound-UDP trick (connect() sends no
    packet; the kernel just picks the egress interface) gets the real
    address; loopback-resolving fallbacks are rejected in favor of the
    next method."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # no packet is sent
            addr = s.getsockname()[0]
        if not addr.startswith("127."):
            return addr
    except OSError:
        pass
    try:
        addr = socket.gethostbyname(socket.gethostname())
        if not addr.startswith("127."):
            return addr
    except OSError:
        pass
    return "127.0.0.1"  # single-host fallback (tests, laptops)


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` exactly from the socket (no intermediate bytes)."""
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-message")
        got += r


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Small fixed-size header reads only — payloads go via _recv_into."""
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return bytes(buf)


_IOV_CHUNK = 512  # comfortably under any platform's IOV_MAX


def _sendmsg_all(sock: socket.socket, views: List) -> int:
    """Scatter-gather send of the whole frame, handling partial sends and
    the kernel's iovec limit.  ``views`` are bytes / byte-cast
    memoryviews; nothing is ever joined into one buffer."""
    views = collections.deque(
        mv for mv in (v if isinstance(v, memoryview) else memoryview(v)
                      for v in views) if len(mv))
    total = sum(len(v) for v in views)
    if not hasattr(sock, "sendmsg"):  # exotic platforms: still no join
        for v in views:
            sock.sendall(v)
        return total
    sent_total = 0
    while views:
        batch = list(itertools.islice(views, _IOV_CHUNK))  # peek a prefix
        sent = sock.sendmsg(batch)
        sent_total += sent
        while sent:  # advance the deque by exactly the bytes accepted
            head = views[0]
            if sent >= len(head):
                sent -= len(head)
                views.popleft()
            else:
                views[0] = head[sent:]
                sent = 0
    return sent_total


# ---------------------------------------------------------------------------
# Window-table dispatch: the native table, or its Python twin when asked
# ---------------------------------------------------------------------------


class _NativeOps:
    """Server-side window ops over the native table (csrc/windows.cc)."""

    def __init__(self, lib):
        self._lib = lib

    def info(self, name_b: bytes) -> Optional[Tuple[int, int, int]]:
        ns = ctypes.c_int()
        ne = ctypes.c_longlong()
        dt = ctypes.c_int()
        if self._lib.bf_win_info(name_b, ctypes.byref(ns), ctypes.byref(ne),
                                 ctypes.byref(dt)) != 0:
            return None
        return ns.value, int(ne.value), dt.value

    def deposit(self, name_b, slot, arr, accumulate) -> int:
        return self._lib.bf_win_deposit(name_b, slot, arr.ctypes.data,
                                        arr.size, 1 if accumulate else 0)

    def read(self, name_b, slot, out, consume) -> int:
        return self._lib.bf_win_read(name_b, slot, out.ctypes.data,
                                     out.size, 1 if consume else 0)

    def read_self(self, name_b, out) -> int:
        return self._lib.bf_win_read_self(name_b, out.ctypes.data, out.size)


class _PyOps:
    """Same ops over the Python twin of the table (``native=False`` or
    ``BLUEFOG_TPU_TORCH_NO_NATIVE=1``), with identical status
    conventions."""

    def __init__(self):
        self._table = _py_windows()

    def info(self, name_b: bytes) -> Optional[Tuple[int, int, int]]:
        got = self._table.info(name_b.decode())
        if got is None:
            return None
        n_slots, n_elems, dtype = got
        return n_slots, n_elems, _DTYPE_IDS[np.dtype(dtype)]

    def deposit(self, name_b, slot, arr, accumulate) -> int:
        return self._table.deposit(name_b.decode(), slot, arr, accumulate)

    def read(self, name_b, slot, out, consume) -> int:
        buf, fresh = self._table.read(name_b.decode(), slot, consume, out)
        return -1 if buf is None else fresh

    def read_self(self, name_b, out) -> int:
        buf = self._table.read_self(name_b.decode())
        if buf is None:
            return -1
        out[:] = buf
        return 0


def _table_ops():
    """The native table unless the environment asks for the Python twin;
    a failed native build raises, it never falls back."""
    return _NativeOps(_native.load()) if _native.enabled() else _PyOps()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class _ApplyWorker:
    """Per-connection background applier for BATCHED deposits: the handler
    thread does nothing but ``recv_into`` free buffers and hand them over;
    this thread decodes + lands them in the window table and sends the
    batch ack when its last item applied.  Both halves release the GIL
    (socket reads, numpy copies/adds), so receive of item N+1 genuinely
    overlaps apply of item N — the server side of the progress-engine
    story, and where the pipelined transport's throughput edge over the
    sync wire comes from on the receiving host.

    Hand-off granularity is ONE WIRE BATCH, not one item: the handler
    accumulates a batch's jobs locally and posts them as a single list,
    so the two threads pay one queue wake-up per frame instead of one per
    leaf (per-item ping-pong costs hundreds of microseconds of scheduler
    latency — more than a small leaf's entire payload).  The bounded
    batch queue (2 frames) is the memory/backpressure bound: the recv
    loop blocks when the applier falls two frames behind.  The ack for
    seq S is sent ONLY after every item of S hit the table — that
    ordering is what makes the client's ``flush()`` a real fence."""

    _MAX_FREE = 256  # pooled payload buffers kept per connection

    def __init__(self, handler, sock, ops, write_lock, peer):
        self._handler = handler
        self._sock = sock
        self._ops = ops
        self._wlock = write_lock
        self._peer = peer
        import queue as _q

        self._jobs: "_q.Queue" = _q.Queue(maxsize=2)
        self._closed = False
        self._free: Dict[int, List[np.ndarray]] = {}
        self._free_mu = _lc.lock("runtime.window_server._ApplyWorker._free_mu")
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"bf-win-apply:{peer}")
        self._thread.start()

    def take_buffer(self, nbytes: int) -> np.ndarray:
        with self._free_mu:
            free = self._free.get(nbytes)
            if free:
                return free.pop()
        return np.empty(max(nbytes, 1), np.uint8)

    def _give_buffer(self, buf: np.ndarray) -> None:
        with self._free_mu:
            free = self._free.setdefault(buf.nbytes, [])
            if len(free) < self._MAX_FREE:
                free.append(buf)

    def submit_batch(self, seq: int, jobs: List, tctx=None) -> None:
        """One wire batch's jobs (('item', …) / ('err', code) entries, in
        arrival order); blocks when the applier is two frames behind.
        ``tctx`` is the frame's wire-propagated trace context
        ``(trace_id, span_id, round)`` or None: the owner-side queue-wait,
        apply and ack spans parent to it."""
        self._jobs.put((seq, jobs, tctx, time.time(), time.perf_counter()))

    def close(self) -> bool:
        """Stop the worker after it drains every queued batch; returns
        True iff the thread is provably finished (callers deciding
        whether an applied high-water mark is FINAL rely on this)."""
        import queue as _q

        self._closed = True  # the loop polls this, so no sentinel race
        try:
            # best effort wake-up; never block the handler's finish()
            self._jobs.put_nowait(None)
        except _q.Full:
            pass
        self._thread.join(timeout=5)
        return not self._thread.is_alive()

    def _loop(self) -> None:
        import queue as _q

        h = self._handler
        while True:
            try:
                batch = self._jobs.get(timeout=1.0)
            except _q.Empty:
                if self._closed:
                    return  # drained and told to stop — no thread leak
                continue
            if batch is None:
                return
            seq, jobs, tctx, t_sub_w, t_sub_p = batch
            t_deq_p = time.perf_counter()
            queue_s = t_deq_p - t_sub_p
            applied = 0
            first_err = 0
            for job in jobs:
                if job[0] == "err":
                    if not first_err:
                        first_err = job[1]
                    continue
                (_, name_b, slot, flags, dtype_id, codec, n_elems, buf,
                 nbytes) = job
                try:
                    rc = h._apply_deposit(self._ops, name_b, slot, flags,
                                          dtype_id, codec, n_elems,
                                          memoryview(buf)[:nbytes])
                except Exception:
                    # nothing a payload contains may kill the applier: a
                    # dead applier acks no one and wedges the connection,
                    # which is strictly worse than a rejected item
                    rc = _ERR_BAD_OP
                self._give_buffer(buf)
                if rc < 0:
                    if not first_err:
                        first_err = rc
                else:
                    applied += 1
            apply_s = time.perf_counter() - t_deq_p
            trec = _tr.get() if tctx is not None else None
            if trec is not None:
                tid_, psid, rnd_ = tctx
                trec.emit("queue_wait", "tcp_srv", t0=t_sub_w,
                          dur=queue_s, parent=psid, round_=rnd_,
                          trace_id=tid_, peer=self._peer, seq=seq)
                trec.emit("apply", "tcp_srv", t0=t_sub_w + queue_s,
                          dur=apply_s, parent=psid, round_=rnd_,
                          trace_id=tid_, peer=self._peer, seq=seq,
                          items=applied)
            _mt.inc("bf_tcp_batches_total", 1.0, peer=self._peer)
            _bb.record("tcp_batch_deposit", seq=seq, applied=applied,
                       err=first_err, peer=self._peer)
            # the stream's applied high-water mark moves before the ack
            # leaves: a reconnecting client must never learn (via
            # STREAM_ATTACH) that an already-applied batch is still
            # outstanding, or it would replay it into a double apply.
            # The first error is latched alongside: if this ack dies
            # with the connection, the reconnect attach reports the
            # error instead of retiring the batch as a success.
            h._note_applied(seq, first_err)
            act = _chaos.fire("ack", peer=self._peer, seq=seq)
            if ((act is not None and act[0] == "drop")
                    or h.server.take_ack_drop()):  # type: ignore[attr-defined]
                # an injected applied-but-unacked failure (a chaos
                # ``ack:drop`` rule, or the drop_next_acks drill): the
                # ambiguity the stream-epoch replay protocol resolves
                for fn in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                           self._sock.close):
                    try:
                        fn()
                    except OSError:
                        pass
                return
            if act is not None and act[0] in ("delay", "stall"):
                time.sleep(act[1])
            ack = _ACK.pack(seq, first_err or applied)
            if h._trace_granted:
                # the extended batch ack: the owner's phase timings ride
                # back so the sender can split its ack latency into
                # queue wait and apply without the owner's trace file
                ack += _ACK_TIMES.pack(
                    min(0xFFFF_FFFF, int(queue_s * 1e6)),
                    min(0xFFFF_FFFF, int(apply_s * 1e6)))
            t_ack_w = time.time()
            try:
                # the ack-after-apply ordering under the per-connection
                # write mutex is the client's flush fence; a peer that
                # stops draining wedges only its own connection
                with self._wlock:
                    self._sock.sendall(ack)
            except OSError:
                return  # peer gone; the recv loop will notice too
            if trec is not None:
                trec.emit("ack", "tcp_srv", t0=t_ack_w,
                          dur=time.time() - t_ack_w, parent=tctx[1],
                          round_=tctx[2], trace_id=tctx[0],
                          peer=self._peer, seq=seq)


def _leaf_views(leaves: List[Tuple[str, np.ndarray]]) -> List:
    """Encode ``[(name, array), ...]`` as SNAPSHOT/PUSH leaf entries
    (``_SNAP_LEAF`` + name + payload per leaf).  Callers prepend their own
    count; the snapshot table holds only wire dtypes (publish validates
    f32/f64)."""
    views: List = []
    for name, arr in leaves:
        nb = name.encode()
        views.append(_SNAP_LEAF.pack(len(nb), _DTYPE_IDS[arr.dtype],
                                     arr.size))
        views.append(nb)
        views.append(memoryview(arr).cast("B"))
    return views


def _recv_leaves(sock: socket.socket, count: int) -> Dict[str, np.ndarray]:
    """Decode ``count`` leaf entries (the :func:`_leaf_views` twin): the
    one reader for SNAPSHOT replies and subscription push frames.  Claimed
    lengths are bounded before any allocation; a malformed header raises
    ``ValueError``, which both clients treat as a dead connection."""
    leaves: Dict[str, np.ndarray] = {}
    for _ in range(count):
        name_len, dtype_id, n_elems = _SNAP_LEAF.unpack(
            _recv_exact(sock, _SNAP_LEAF.size))
        if (dtype_id not in _DTYPES or n_elems < 0
                or name_len > _MAX_LEAF_NAME
                or n_elems * _DTYPES[dtype_id].itemsize > _MAX_LEAF_BYTES):
            raise ValueError("snapshot leaf header out of bounds")
        name = _recv_exact(sock, name_len).decode("utf-8", "replace")
        out = np.empty(n_elems, _DTYPES[dtype_id])
        _recv_into(sock, memoryview(out).cast("B"))
        leaves[name] = out
    return leaves


def _delta_leaf_views(items) -> List:
    """Encode a :meth:`DeltaEncoder.step` item list as op-10 delta leaf
    entries (``_DELTA_LEAF`` + name + codec payload per leaf)."""
    views: List = []
    for name, dtype, codec, n_elems, payload_views, wire_b in items:
        nb = name.encode()
        views.append(_DELTA_LEAF.pack(len(nb), _DTYPE_IDS[dtype], codec,
                                      n_elems, wire_b))
        views.append(nb)
        views.extend(payload_views)
    return views


def _recv_delta_leaves(sock: socket.socket, count: int) -> List:
    """Decode ``count`` op-10 delta leaf entries (the
    :func:`_delta_leaf_views` twin) into ``(name, dtype, codec, n_elems,
    payload)`` tuples for :meth:`DeltaApplier.apply`.  Claimed lengths are
    bounded before any allocation; a malformed entry raises
    ``ValueError`` (a dead connection: the cursor never moves on a frame
    that did not fully parse)."""
    items: List = []
    for _ in range(count):
        name_len, dtype_id, codec, n_elems, wire_b = _DELTA_LEAF.unpack(
            _recv_exact(sock, _DELTA_LEAF.size))
        if (dtype_id not in _DTYPES or codec not in wire_codec.CODEC_NAMES
                or n_elems < 0 or wire_b < 0 or name_len > _MAX_LEAF_NAME
                or wire_b > wire_codec.wire_bytes_bound(
                    n_elems, _DTYPES[dtype_id].itemsize)):
            raise ValueError("delta leaf header out of bounds")
        name = _recv_exact(sock, name_len).decode("utf-8", "replace")
        payload = bytearray(wire_b)
        _recv_into(sock, memoryview(payload))
        items.append((name, _DTYPES[dtype_id], codec, n_elems,
                      memoryview(payload)))
    return items


class _SubSender:
    """Per-subscription background pusher: blocks in the snapshot table's
    publish wait and pushes the latest due round to its reader.

    The slow-reader policy is skip-to-latest: the sender never queues more
    than the one snapshot it is serialising, so a reader that cannot keep
    up receives fewer, newer snapshots (``skipped`` counts the due rounds
    it missed), and nothing here can hold the training loop back: publish
    never waits on a subscriber.  A reader that stops draining its socket
    blocks only this thread in ``sendall``; the next epoch's attach, or
    the reader's death reaching TCP, tears it down.  Keepalive frames
    (round = -1) flow when nothing is published, so a live but idle server
    never trips the reader's silence detector."""

    def __init__(self, handler, sock, wmu, group: str, every: int,
                 cursor: int, peer: str, sid: int, epoch: int):
        self._handler = handler
        self._sock = sock
        self._wmu = wmu
        self._group = group
        self._every = max(1, int(every))
        # the client-held cursor is the delivery truth: nothing at or
        # below it is pushed again (no duplicates), and pushes always
        # carry the latest round above it (no misses)
        self._last_round = int(cursor)
        self._peer = peer
        self.sid = sid
        self.epoch = epoch
        self._closed = threading.Event()
        # delta pushes ride only connections whose HELLO negotiated
        # FEATURE_DELTA; the encoder is per connection (a reconnect gets a
        # fresh one, which forces the full-frame anchor after a gap)
        self._delta_on = bool(handler._delta_granted)
        self._enc = _delta.DeltaEncoder() if self._delta_on else None
        # start one generation behind the table: a subscriber attaching
        # after the latest publish must still receive the current round
        # when its cursor is below it
        gen = handler.server.snap_table.generation(group)
        self._gen = gen - 1 if gen > 0 else 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"bf-sub:{peer}")
        self._thread.start()

    def close(self) -> bool:
        """Stop the sender (idempotent; callable from any thread).
        Closing the socket kicks a sender blocked mid-``sendall``."""
        self._closed.set()
        for fn in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                   self._sock.close):
            try:
                fn()
            except OSError:
                pass
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5)
            return not self._thread.is_alive()
        return True

    def _send(self, views) -> bool:
        try:
            with self._wmu:
                _sendmsg_all(self._sock, views)
            return True
        except (OSError, ConnectionError):
            return False

    def _keepalive_due(self) -> bool:
        return time.monotonic() - self._last_send >= _SUB_KEEPALIVE_S

    def _ka_views(self) -> List:
        """A keepalive frame (round = -1), with an empty trace header on
        FEATURE_TRACE connections and an empty delta header on
        FEATURE_DELTA connections, so every push frame parses the same
        way."""
        views: List = [_PUSH.pack(-1, 0, 0)]
        if self._handler._trace_granted:
            views.append(_TRACE_HDR.pack(0, 0, 0))
        if self._delta_on:
            views.append(_DELTA_HDR.pack(0, -1))
        return views

    def _payload_views(self, rnd: int, leaves) -> List:
        """The frame body after the trace header: dense leaves on plain
        connections; on
        FEATURE_DELTA connections the delta header plus either the
        full-frame anchor or the encoded round-over-round delta, per the
        server's live :class:`DeltaConfig` (read fresh each push)."""
        if not self._delta_on:
            return _leaf_views(leaves)
        cfg = self._handler.server.delta_cfg
        kind, base_rnd, items = self._enc.step(rnd, leaves, cfg)
        if kind == _OP_DELTA:
            return ([_DELTA_HDR.pack(_OP_DELTA, base_rnd)]
                    + _delta_leaf_views(items))
        return [_DELTA_HDR.pack(0, -1)] + _leaf_views(leaves)

    def _loop(self) -> None:
        tbl = self._handler.server.snap_table
        self._last_send = time.monotonic()
        while not self._closed.is_set():
            gen = tbl.wait_newer(self._group, self._gen,
                                 timeout_s=_SUB_KEEPALIVE_S)
            if self._closed.is_set():
                return
            if gen is None:
                if not self._send(self._ka_views()):
                    return
                self._last_send = time.monotonic()
                continue
            self._gen = gen
            try:
                rnd, leaves = tbl.read(self._group)
            except _snap.SnapshotUnavailable:
                continue  # dropped between the notify and the read
            if self._last_round >= 0 and rnd < self._last_round + self._every:
                # not due yet (the every-Nth-round contract); a steady
                # stream of publishes that are not due must not starve the
                # keepalive cadence
                if self._keepalive_due():
                    if not self._send(self._ka_views()):
                        return
                    self._last_send = time.monotonic()
                continue
            skipped = (max(0, (rnd - self._last_round) - self._every)
                       if self._last_round >= 0 else 0)
            # push-frame trace context: the reader's consume span parents
            # to this push span, so a delivered snapshot links causally
            # back to the serving host
            thdr: List = []
            psp = None
            if self._handler._trace_granted:
                trec = _tr.get()
                if trec is not None:
                    # parent to the publish's stored trace context when
                    # the publisher carried one (a relay hop parents to
                    # the upstream push this way, so the analyzer walks
                    # trainer -> relay -> leaf across the whole tree)
                    ptc = tbl.trace_ctx(self._group)
                    psp = trec.begin_span(
                        "push", "tcp_srv", round_=max(0, rnd),
                        parent=ptc[1] if ptc else 0,
                        trace_id=ptc[0] if ptc else None,
                        group=self._group, peer=self._peer,
                        skipped=skipped)
                thdr = [_TRACE_HDR.pack(
                    psp.tid if psp is not None else 0,
                    psp.sid if psp is not None else 0, max(0, rnd))]
            try:
                # the frame body is built once (the delta encoder's error
                # feedback advances per push)
                views = ([_PUSH.pack(rnd, skipped, len(leaves))] + thdr
                         + self._payload_views(rnd, leaves))
                act = _chaos.fire("sub", peer=self._peer, group=self._group)
                if act is not None:
                    if act[0] in ("delay", "stall"):
                        time.sleep(act[1])
                    else:
                        # an injected reader-side outage: cut the push
                        # channel (after half a frame for 'truncate', the
                        # torn frame a resuming reader must not consume)
                        if act[0] == "truncate":
                            self._send(views[:max(1, len(views) // 2)])
                        self.close()
                        return
                if not self._send(views):
                    return
            finally:
                if psp is not None:
                    psp.finish()
            self._last_send = time.monotonic()
            self._last_round = rnd


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server.track(self.request)  # type: ignore[attr-defined]
        _bb.record("tcp_connect", peer=self.client_address[0])
        # reusable per-connection receive/decode scratch (grown once per
        # high-water mark, then no allocation on the hot path)
        self._pay: Dict[int, np.ndarray] = {}     # dtype id -> raw buffer
        self._dense: Dict[int, np.ndarray] = {}   # dtype id -> decode dst
        self._out: Dict[int, np.ndarray] = {}     # dtype id -> reply buffer
        self._name = bytearray(256)
        self._discard = None  # allocated only if a bad item must be eaten
        self._deferred_applied = 0
        self._deferred_err = 0
        # replies can come from two threads once a batch stream starts
        # (handler: sync ops; apply worker: batch acks): serialise writes
        self._wmu = _lc.lock("runtime.window_server._Handler._wmu")
        self._worker: Optional[_ApplyWorker] = None  # created on 1st batch
        # DepositStream lineage binding (STREAM_ATTACH); None = unbound
        self._stream_sid: Optional[int] = None
        self._stream_epoch = 0
        # FEATURE_TRACE negotiated on this connection: frames of the
        # _TRACED_OPS carry the trace header, batch acks grow the timing
        # tail, push frames carry the header (set at HELLO, so presence is
        # deterministic per connection)
        self._trace_granted = False
        # FEATURE_DELTA negotiated on this connection: push frames carry
        # the delta header and may be op-10 deltas (set at HELLO)
        self._delta_granted = False
        # subscription push sender (SUBSCRIBE); None = plain connection
        self._sub: Optional[_SubSender] = None

    def _send(self, data) -> None:
        with self._wmu:
            self.request.sendall(data)

    def _send_views(self, views) -> None:
        with self._wmu:
            _sendmsg_all(self.request, views)

    def finish(self):
        _bb.record("tcp_disconnect", peer=self.client_address[0])
        if self._worker is not None:
            self._worker.close()
        if self._sub is not None:
            self._sub.close()
            self.server.note_sub(-1)  # type: ignore[attr-defined]
            self._sub = None
        self.server.untrack(self.request)  # type: ignore[attr-defined]

    def quiesce_sub(self) -> bool:
        """Fence a superseded SUBSCRIBE connection: close its socket and
        stop its push sender, so the old epoch can push nothing after the
        successor's accept reply.  Idempotent against ``finish``."""
        for fn in (lambda: self.request.shutdown(socket.SHUT_RDWR),
                   self.request.close):
            try:
                fn()
            except OSError:
                pass
        s = self._sub
        if s is not None:
            return s.close()
        return True

    def quiesce(self) -> bool:
        """Fence a superseded connection: close its socket and DRAIN its
        apply worker, so nothing of the old stream generation can land
        after the successor's STREAM_ATTACH reply.  Called by the server
        when a newer epoch of the same stream attaches; safe to race
        with this handler's own ``finish`` (both paths are idempotent).
        Returns False when the worker could not be proven drained (the
        attach must then refuse rather than reply a non-final mark)."""
        for fn in (lambda: self.request.shutdown(socket.SHUT_RDWR),
                   self.request.close):
            try:
                fn()
            except OSError:
                pass
        w = self._worker
        if w is not None:
            return w.close()  # joins: the worker drains every batch
        return True

    def _note_applied(self, seq: int, err: int = 0) -> None:
        """Apply-worker callback: advance this stream's applied
        high-water mark and latch the first batch error (no-op for
        connections that never attached)."""
        if self._stream_sid is not None:
            self.server.note_applied(  # type: ignore[attr-defined]
                self._stream_sid, self._stream_epoch, seq, err)

    # ------------------------------------------------------------ plumbing
    def _geometry(self, ops, name_b):
        return ops.info(name_b)

    def _pay_buf(self, dtype_id: int, nbytes: int) -> np.ndarray:
        buf = self._pay.get(dtype_id)
        if buf is None or buf.nbytes < nbytes:
            buf = np.empty(max(nbytes, 1), np.uint8)
            self._pay[dtype_id] = buf
        return buf

    def _dense_buf(self, dtype_id: int, n_elems: int) -> np.ndarray:
        buf = self._dense.get(dtype_id)
        if buf is None or buf.size < n_elems:
            buf = np.empty(max(n_elems, 1), _DTYPES[dtype_id])
            self._dense[dtype_id] = buf
        return buf

    def _out_buf(self, dtype_id: int, n_elems: int) -> np.ndarray:
        buf = self._out.get(dtype_id)
        if buf is None or buf.size < n_elems:
            buf = np.empty(max(n_elems, 1), _DTYPES[dtype_id])
            self._out[dtype_id] = buf
        return buf

    def _eat(self, sock, nbytes: int) -> None:
        """Consume and discard ``nbytes`` of payload (bad item in a batch)
        without allocating proportionally to the claimed length."""
        if self._discard is None:
            self._discard = bytearray(1 << 20)
        mv = memoryview(self._discard)
        while nbytes > 0:  # strict: a negative count must never turn the
            # python slice below into a giant read of unsent bytes
            chunk = min(nbytes, len(mv))
            _recv_into(sock, mv[:chunk])
            nbytes -= chunk

    def _recv_name(self, sock, name_len: int) -> bytes:
        if name_len > len(self._name):
            self._name = bytearray(name_len)
        mv = memoryview(self._name)[:name_len]
        _recv_into(sock, mv)
        return bytes(mv)

    # ------------------------------------------------------------ handlers
    def _apply_deposit(self, ops, name_b, slot, flags, dtype_id, codec,
                       n_elems, payload_mv) -> int:
        """Decode (if needed) and land one validated deposit; returns the
        native status (deposit count) or a negative error."""
        if codec == wire_codec.CODEC_NONE:
            if len(payload_mv) != n_elems * _DTYPES[dtype_id].itemsize:
                return _ERR_CODEC  # belt-and-braces; validated upstream
            # zero-copy: a dtype view over the receive buffer
            arr = np.frombuffer(payload_mv, _DTYPES[dtype_id],
                                count=n_elems)
        else:
            try:
                # exact-size VIEW of the grown scratch: decode requires
                # out.size == n_elems, so handing it the whole buffer
                # would silently allocate fresh per item
                arr = wire_codec.decode(
                    codec, payload_mv, n_elems, _DTYPES[dtype_id],
                    out=self._dense_buf(dtype_id, n_elems)[:n_elems])
            except ValueError:
                return _ERR_CODEC
        rc = ops.deposit(name_b, slot, arr,
                         bool(flags & _FLAG_ACCUMULATE))
        if rc >= 0:
            nbytes = n_elems * _DTYPES[dtype_id].itemsize
            window = name_b.decode("utf-8", "replace")
            peer = self.client_address[0]
            _mt.inc("bf_tcp_deposit_bytes_total", nbytes, window=window,
                    peer=peer)
            _mt.inc("bf_tcp_deposits_total", 1.0, peer=peer)
            _bb.record("tcp_deposit", slot=slot, bytes=nbytes, window=window,
                       peer=peer)
            if flags & _FLAG_DRAIN:
                # a graceful leaver handed its push-sum mass to this
                # owner: recorded where the receiving side's forensics
                # look
                self.server.note_drain()  # type: ignore[attr-defined]
                _mt.inc("bf_drain_deposits_total", 1.0, peer=peer)
                _bb.record("drain_deposit", slot=slot, window=window,
                           peer=peer)
        return rc

    def _batch_ack(self, seq: int, status: int) -> None:
        """Handler-thread batch ack (the dedup and unparseable-stream
        paths): it carries the timing tail on trace connections, so the
        ack stream parses the same whichever thread acked."""
        ack = _ACK.pack(seq, status)
        if self._trace_granted:
            ack += _ACK_TIMES.pack(0, 0)
        self._send(ack)

    def _handle_batch(self, ops, sock, tctx=None) -> bool:
        """One DEPOSIT_BATCH frame; returns False to drop the connection
        (only when the stream itself is unrecoverable).  The handler
        thread only validates headers and ``recv_into``s payloads; the
        per-connection :class:`_ApplyWorker` decodes and lands them, so
        receiving item N+1 overlaps applying item N.  The ack is emitted
        by the worker after the batch's last item applied.  ``tctx`` is
        the frame's trace context: the owner-side recv span is emitted
        here, the queue-wait, apply and ack spans by the worker."""
        if self._worker is None:
            self._worker = _ApplyWorker(
                self, sock, ops, self._wmu, self.client_address[0])
        worker = self._worker
        trec = _tr.get() if tctx is not None else None
        t_recv_w = time.time()
        t_recv_p = time.perf_counter()
        seq, count = _BATCH_HDR.unpack(_recv_exact(sock, _BATCH_HDR.size))
        if self._stream_sid is not None and seq <= self.server.stream_applied(  # type: ignore[attr-defined]
                self._stream_sid):
            # replayed duplicate of a batch this stream already applied
            # (it was in flight, applied, but un-acked when the previous
            # connection died): consume the frame WITHOUT touching the
            # window table, ack as applied — server-side exactly-once
            for _ in range(count):
                (name_len, _slot, _flags, dt, _codec, n_elems,
                 wire_bytes) = _ITEM.unpack(_recv_exact(sock, _ITEM.size))
                if (wire_bytes < 0 or n_elems < 0 or dt not in _DTYPES
                        or wire_bytes > wire_codec.wire_bytes_bound(
                            n_elems, _DTYPES[dt].itemsize)):
                    # same bound discipline as the fresh path: a lying
                    # duplicate cannot make the server consume unbounded
                    # claimed bytes
                    self._batch_ack(seq, _ERR_BAD_OP)
                    return False
                self._recv_name(sock, name_len)
                self._eat(sock, wire_bytes)
            self.server.note_dedup()  # type: ignore[attr-defined]
            _mt.inc("bf_tcp_deduped_batches_total", 1.0,
                    peer=self.client_address[0])
            _bb.record("tcp_dedup_batch", seq=seq, items=count,
                       peer=self.client_address[0])
            self._batch_ack(seq, count)
            return True
        jobs: List = []
        for _ in range(count):
            (name_len, slot, flags, dtype_id, codec, n_elems,
             wire_bytes) = _ITEM.unpack(_recv_exact(sock, _ITEM.size))
            if (dtype_id not in _DTYPES or n_elems < 0 or wire_bytes < 0
                    or codec not in wire_codec.CODEC_NAMES):
                # lengths are unparseable -> the stream cannot be resynced
                self._batch_ack(seq, _ERR_BAD_OP)
                return False
            name_b = self._recv_name(sock, name_len)
            err = 0
            itemsize = _DTYPES[dtype_id].itemsize
            if wire_bytes > wire_codec.wire_bytes_bound(n_elems, itemsize):
                err = _ERR_TOO_LARGE
            elif (codec == wire_codec.CODEC_NONE
                  and wire_bytes != n_elems * itemsize) or (
                      codec == wire_codec.CODEC_F32
                      and wire_bytes != n_elems * 4):
                # fixed-length codecs must claim EXACTLY their length: an
                # under-length dense payload would otherwise blow up in
                # the applier, and an over-length one smuggle trailing
                # garbage (topk is variable-length; decode validates it)
                err = _ERR_GEOMETRY
            elif not self.server.features_granted(  # type: ignore
                    self.request, _CODEC_FEATURE.get(codec, 0)):
                err = _ERR_CODEC
            else:
                info = self._geometry(ops, name_b)
                if info is None:
                    err = _ERR_NO_WINDOW
                elif info[2] != dtype_id or info[1] != n_elems:
                    err = _ERR_GEOMETRY
            if err:
                self._eat(sock, wire_bytes)
                jobs.append(("err", err))
                continue
            buf = worker.take_buffer(wire_bytes)
            _recv_into(sock, memoryview(buf)[:wire_bytes])
            jobs.append(("item", name_b, slot, flags, dtype_id, codec,
                         n_elems, buf, wire_bytes))
        if trec is not None:
            trec.emit("recv", "tcp_srv", t0=t_recv_w,
                      dur=time.perf_counter() - t_recv_p,
                      parent=tctx[1], round_=tctx[2], trace_id=tctx[0],
                      peer=self.client_address[0], seq=seq, items=count)
        worker.submit_batch(seq, jobs, tctx)
        return True

    def _handle_snapshot(self, sock, name_len: int, tctx=None) -> bool:
        """One SNAPSHOT request: all requested leaves from one round, or a
        retriable negative status; returns False to drop the connection
        (an unparseable request, or an injected read fault).  ``tctx`` is
        the reader's trace context: the serve span parents to it, so the
        read links causally into the reader's trace."""
        t_serve_w = time.time()
        t_serve_p = time.perf_counter()
        group = self._recv_name(sock, name_len).decode("utf-8", "replace")
        want_round, count = _SNAP_REQ.unpack(
            _recv_exact(sock, _SNAP_REQ.size))
        if count > _MAX_SNAP_LEAVES:
            self._send(_STATUS.pack(_ERR_BAD_OP))
            return False
        names: List[str] = []
        for _ in range(count):
            (ln,) = _LEAF_NAME.unpack(_recv_exact(sock, _LEAF_NAME.size))
            if ln > _MAX_LEAF_NAME:
                self._send(_STATUS.pack(_ERR_BAD_OP))
                return False
            names.append(self._recv_name(sock, ln).decode("utf-8", "replace"))
        try:
            rnd, leaves = self.server.snap_table.read(  # type: ignore
                group, names or None,
                want_round=want_round if want_round >= 0 else -1)
        except _snap.RoundRolled:
            self._send(_STATUS.pack(_ERR_ROUND_ROLLED))
            return True
        except _snap.SnapshotUnavailable:
            self._send(_STATUS.pack(_ERR_NO_SNAPSHOT))
            return True
        views = ([_STATUS.pack(rnd), _SNAP_CNT.pack(len(leaves))]
                 + _leaf_views(leaves))
        act = _chaos.fire("read", op="snapshot",
                          peer=self.client_address[0])
        if act is not None:
            if act[0] in ("delay", "stall"):
                time.sleep(act[1])
            elif act[0] == "truncate":
                # a torn reply frame, then the cut: the client must
                # detect it and retry a fresh read, never consume the
                # fragment as a snapshot
                self._send_views(views[:max(1, len(views) // 2)])
                return False
            else:  # drop
                return False
        self._send_views(views)
        trec = _tr.get() if tctx is not None else None
        if trec is not None:
            trec.emit("snapshot_serve", "tcp_srv", t0=t_serve_w,
                      dur=time.perf_counter() - t_serve_p,
                      parent=tctx[1], round_=tctx[2], trace_id=tctx[0],
                      peer=self.client_address[0], group=group,
                      served_round=rnd)
        return True

    def _handle_subscribe(self, sock, name_len: int) -> bool:
        """One SUBSCRIBE request: bind this connection as the push channel
        of a subscriber lineage and start its sender."""
        group = self._recv_name(sock, name_len).decode("utf-8", "replace")
        sid, epoch, every, cursor = _SUB_REQ.unpack(
            _recv_exact(sock, _SUB_REQ.size))
        if self._sub is not None:
            # one subscription a connection: a second SUBSCRIBE on the
            # same socket would interleave two push streams' framing
            self._send(_STATUS.pack(_ERR_BAD_OP))
            return False
        if not self.server.sub_reserve():  # type: ignore[attr-defined]
            # the tree plan's degree: a relay at its fan-out limit refuses
            # retriably; the reader backs off or finds a sibling
            self._send(_STATUS.pack(_ERR_BUSY))
            return False
        rc = self.server.attach_sub(sid, epoch, self)  # type: ignore
        if rc < 0:
            self.server.note_sub(-1)  # type: ignore[attr-defined]
            self._send(_STATUS.pack(rc))
            return False
        self._send(_STATUS.pack(0))
        self._sub = _SubSender(self, sock, self._wmu, group, every, cursor,
                               self.client_address[0], sid=sid, epoch=epoch)
        return True

    def handle(self):
        ops = self.server.ops  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while True:
                try:
                    hdr = _recv_exact(sock, _HDR.size)
                except ConnectionError:
                    return  # peer done
                magic, op, name_len = _HDR.unpack(hdr)
                if magic == _MAGIC_V1:
                    # an old client: reject LOUDLY (it is blocked on an
                    # 8-byte status right now), then drop — never try to
                    # parse a v1 stream as v2
                    self._send(_STATUS.pack(_ERR_VERSION))
                    return
                if magic != _MAGIC:
                    return  # not ours; drop the connection
                act = _chaos.fire("server", op=op,
                                  peer=self.client_address[0])
                if act is not None:
                    if act[0] in ("drop", "truncate"):
                        # 'truncate' differs from 'drop' only in where it
                        # cuts: the frame header was consumed, the body
                        # was not; the client sees a connection that died
                        # mid-frame either way
                        return
                    time.sleep(act[1])  # delay or stall
                # wire-propagated trace context: present iff this
                # connection's HELLO negotiated FEATURE_TRACE and the op
                # is one of the traced client->server frames (read after
                # the chaos shim, so an injected 'truncate' still models
                # "header consumed, body not").  span_id 0 = the sender
                # had no active span: parse, then ignore.
                tctx = None
                if self._trace_granted and op in _TRACED_OPS:
                    t_id, s_id, t_round = _TRACE_HDR.unpack(
                        _recv_exact(sock, _TRACE_HDR.size))
                    if s_id:
                        tctx = (t_id, s_id, t_round)
                if op == _OP_SNAPSHOT:
                    if not self._handle_snapshot(sock, name_len, tctx):
                        return
                    continue
                if op == _OP_SUBSCRIBE:
                    if not self._handle_subscribe(sock, name_len):
                        return
                    continue
                if op == _OP_HEARTBEAT:
                    (hb_seq,) = _HB.unpack(_recv_exact(sock, _HB.size))
                    self._send(_ACK.pack((hb_seq & ~_HB_MARK) | _HB_MARK, 0))
                    continue
                if op == _OP_STREAM_ATTACH:
                    sid, epoch = _ATTACH.unpack(
                        _recv_exact(sock, _ATTACH.size))
                    rc = self.server.attach_stream(  # type: ignore
                        sid, epoch, self)
                    self._send(_STATUS.pack(rc))
                    if rc < 0:
                        return  # zombie generation; drop it
                    self._stream_sid = sid
                    self._stream_epoch = epoch
                    continue
                if op == _OP_HELLO:
                    body = _recv_exact(sock, _HELLO.size)
                    version, features = _HELLO.unpack(body)
                    if version != PROTOCOL_VERSION:
                        self._send(_STATUS.pack(_ERR_VERSION))
                        return
                    granted = features & _SERVER_FEATURES
                    self.server.set_features(self.request, granted)  # type: ignore
                    self._trace_granted = bool(granted & FEATURE_TRACE)
                    self._delta_granted = bool(granted & FEATURE_DELTA)
                    self._send(_STATUS.pack(granted))
                    continue
                if op == _OP_DEPOSIT_BATCH:
                    if not self._handle_batch(ops, sock, tctx):
                        return
                    continue
                if op == _OP_FLUSH:
                    rc = self._deferred_err or self._deferred_applied
                    self._deferred_err = 0
                    self._deferred_applied = 0
                    _bb.record("tcp_flush", peer=self.client_address[0],
                               status=rc)
                    self._send(_STATUS.pack(rc))
                    continue
                name = self._recv_name(sock, name_len)
                slot, flags, dtype, n_elems = _BODY.unpack(
                    _recv_exact(sock, _BODY.size))
                if dtype not in _DTYPES or n_elems < 0 or op not in (
                        _OP_DEPOSIT, _OP_GET_SELF, _OP_READ_SLOT):
                    self._send(_STATUS.pack(_ERR_BAD_OP))
                    return  # cannot even parse the payload; drop
                info = self._geometry(ops, name)
                err = 0
                if info is None:
                    err = _ERR_NO_WINDOW
                elif info[2] != dtype or info[1] != n_elems:
                    # the client's claimed (dtype, n_elems) must MATCH the
                    # window's geometry before anything is allocated: the C
                    # entry points validate n_elems only and copy nbytes =
                    # n_elems * window_elem_size — a lying dtype would over-
                    # read the payload or overflow the reply buffer, and a
                    # huge n_elems would allocate unbounded owner memory
                    err = _ERR_GEOMETRY
                if op == _OP_DEPOSIT:
                    deferred = bool(flags & _FLAG_DEFERRED_ACK)
                    if err:
                        if deferred:
                            # the payload length is client-claimed but
                            # parseable (dense wire): eat it, latch, go on
                            self._eat(sock,
                                      n_elems * _DTYPES[dtype].itemsize)
                            if not self._deferred_err:
                                self._deferred_err = err
                            continue
                        # sync path keeps v1's posture: report and drop
                        self._send(_STATUS.pack(err))
                        return
                    nbytes = n_elems * _DTYPES[dtype].itemsize
                    buf = self._pay_buf(dtype, nbytes)
                    mv = memoryview(buf)[:nbytes]
                    _recv_into(sock, mv)
                    rc = self._apply_deposit(
                        ops, name, slot, flags, dtype,
                        wire_codec.CODEC_NONE, n_elems, mv)
                    if deferred:
                        if rc >= 0:
                            self._deferred_applied += 1
                        elif not self._deferred_err:
                            self._deferred_err = rc
                        continue
                    self._send(_STATUS.pack(rc))
                    continue
                if err:
                    self._send(_STATUS.pack(err))
                    continue
                out = self._out_buf(dtype, n_elems)[:n_elems]
                if op == _OP_GET_SELF:
                    rc = ops.read_self(name, out)
                else:
                    rc = ops.read(name, slot, out, bool(flags & 1))
                if rc < 0:
                    self._send(_STATUS.pack(rc))
                    continue
                reply = [_STATUS.pack(rc), _SELF_HDR.pack(dtype, n_elems),
                         memoryview(out).cast("B")]
                act = _chaos.fire(
                    "read", op="get_self" if op == _OP_GET_SELF
                    else "read_slot", peer=self.client_address[0])
                if act is not None:
                    if act[0] in ("delay", "stall"):
                        time.sleep(act[1])
                    elif act[0] == "truncate":
                        # the status and the header, then the cut: the
                        # reader sees a reply torn mid-frame
                        self._send_views(reply[:2])
                        return
                    else:  # drop
                        return
                self._send_views(reply)
        except (ConnectionError, OSError):
            return


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True

    _MAX_STREAMS = 512  # attach-state entries kept (oldest evicted)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns: set = set()
        self._features: Dict[int, int] = {}  # id(sock) -> granted mask
        self._conns_mu = _lc.lock("runtime.window_server._Server._conns_mu")
        # DepositStream lineage state: stream_id -> [epoch, applied_seq,
        # handler, last_activity, first_err].  Survives connection churn:
        # the applied high-water mark is what makes replay after a
        # reconnect idempotent, and the latched first batch error keeps a
        # rejected deposit loud even when the connection died before its
        # negative ack got out.
        self._streams: Dict[int, list] = {}
        self._streams_mu = _lc.lock(
            "runtime.window_server._Server._streams_mu")
        # drain-flagged deposits applied (graceful leavers' handoffs)
        self.drain_deposits = 0
        # replayed duplicates consumed without an apply (exactly once)
        self.deduped_batches = 0
        # injected applied-but-unacked failures still to fire
        self._ack_drops = 0
        # subscriber lineage state: sub_id -> [epoch, handler,
        # last_activity].  The deposit streams' epoch discipline on the
        # read path: a reconnecting subscriber's newer epoch quiesces the
        # superseded push sender, so no zombie pushes beside its successor
        self._subs: Dict[int, list] = {}
        self._subs_mu = _lc.lock("runtime.window_server._Server._subs_mu")
        self._live_subs = 0
        # the snapshot table this server serves: the process-global one by
        # default (trainers), a private one for a relay that re-publishes
        # upstream groups (WindowServer(snapshots=...))
        self.snap_table: _snap.SnapshotTable = _snap.table()
        # the live delta cadence and codec of this server's push senders,
        # swapped whole by the tree plan's actuation at round boundaries;
        # senders read it fresh per push
        self.delta_cfg: _delta.DeltaConfig = _delta.DeltaConfig()
        # fan-out admission limit (None = unlimited): the TreePlan's degree
        self.sub_limit: Optional[int] = None

    def note_drain(self) -> None:
        with self._conns_mu:
            self.drain_deposits += 1

    def note_dedup(self) -> None:
        with self._conns_mu:
            self.deduped_batches += 1

    def take_ack_drop(self) -> bool:
        if not self._ack_drops:
            return False
        with self._conns_mu:
            if self._ack_drops:
                self._ack_drops -= 1
                return True
        return False

    def sub_reserve(self) -> bool:
        """Atomically claim one subscription slot under the fan-out limit
        (check and increment in one critical section: the children of a
        dead relay re-parenting at once must not overshoot the degree).
        The claimer releases with ``note_sub(-1)`` on a later failure or
        at teardown."""
        with self._subs_mu:
            if (self.sub_limit is not None
                    and self._live_subs >= self.sub_limit):
                return False
            self._live_subs += 1
            return True

    # -------------------------------------------------- subscriber lineage
    def attach_sub(self, sid: int, epoch: int, handler) -> int:
        """Bind ``handler`` as the live push connection of subscriber
        ``sid`` at ``epoch``; quiesces the superseded connection before
        accepting.  0 on success, ``-105`` when the epoch is not strictly
        newer."""
        with self._subs_mu:
            st = self._subs.get(sid)
            if st is not None and epoch <= st[0]:
                return _ERR_STALE_EPOCH
            old = st[1] if st is not None else None
        if old is not None and old is not handler:
            # outside the lock: the quiesce joins the old sender thread
            old.quiesce_sub()
        with self._subs_mu:
            st = self._subs.get(sid)
            if st is None:
                if len(self._subs) >= self._MAX_STREAMS:
                    oldest = min(self._subs, key=lambda k: self._subs[k][2])
                    del self._subs[oldest]
                st = self._subs[sid] = [0, None, time.monotonic()]
            if epoch <= st[0]:
                return _ERR_STALE_EPOCH  # lost an attach race
            st[0] = epoch
            st[1] = handler
            st[2] = time.monotonic()
        return 0

    def note_sub(self, delta: int) -> None:
        with self._subs_mu:
            self._live_subs = max(0, self._live_subs + delta)

    # ------------------------------------------------------ stream lineage
    def attach_stream(self, sid: int, epoch: int, handler) -> int:
        """Bind ``handler`` as the live connection of stream ``sid`` at
        ``epoch``.  Quiesces the superseded connection (if any) BEFORE
        replying, so the returned applied-seq is final for everything the
        old generation received.  Returns the applied high-water mark;
        ``_ERR_STALE_EPOCH`` if ``epoch`` is not strictly newer;
        ``_ERR_BUSY`` (retryable) if the old generation could not be
        proven drained; or the stream's latched first batch error —
        errors must not be silently retired by a reconnect."""
        with self._streams_mu:
            st = self._streams.get(sid)
            if st is not None and epoch <= st[0]:
                return _ERR_STALE_EPOCH
            old_handler = st[2] if st is not None else None
        if old_handler is not None and old_handler is not handler:
            # outside the lock: quiesce JOINS the old apply worker (it
            # may be mid-deposit), and note_applied from that drain needs
            # the lock
            if not old_handler.quiesce():
                # a wedged old applier means the mark below could still
                # move AFTER our reply — refuse (retryably) rather than
                # hand out a non-final mark and risk a double apply
                return _ERR_BUSY
        with self._streams_mu:
            st = self._streams.get(sid)
            if st is None:
                if len(self._streams) >= self._MAX_STREAMS:
                    oldest = min(self._streams,
                                 key=lambda k: self._streams[k][3])
                    del self._streams[oldest]
                st = self._streams[sid] = [0, 0, None, time.monotonic(), 0]
            if epoch <= st[0]:
                return _ERR_STALE_EPOCH  # lost an attach race
            st[0] = epoch
            st[2] = handler
            st[3] = time.monotonic()
            if st[4]:
                # the stream already rejected a deposit (and the ack may
                # have died with the old connection): report THAT, not a
                # clean resume point — the client fails loudly exactly as
                # the lost ack would have made it
                return st[4]
            return st[1]

    def stream_applied(self, sid: int) -> int:
        with self._streams_mu:
            st = self._streams.get(sid)
            return st[1] if st is not None else 0

    def note_applied(self, sid: int, epoch: int, seq: int,
                     err: int = 0) -> None:
        """Advance the applied high-water mark (monotonic) and latch the
        stream's first batch error.  The epoch is deliberately NOT
        checked: a drained old-generation worker's applies are real
        applies, and recording them is exactly what keeps the successor's
        replay from repeating them.  Touching last_activity keeps busy
        lineages out of the eviction scan's reach."""
        with self._streams_mu:
            st = self._streams.get(sid)
            if st is not None:
                if seq > st[1]:
                    st[1] = seq
                if err and not st[4]:
                    st[4] = err
                st[3] = time.monotonic()

    def track(self, sock):
        with self._conns_mu:
            self._conns.add(sock)

    def untrack(self, sock):
        with self._conns_mu:
            self._conns.discard(sock)
            self._features.pop(id(sock), None)

    def set_features(self, sock, granted: int):
        with self._conns_mu:
            self._features[id(sock)] = granted

    def features_granted(self, sock, needed: int) -> bool:
        if not needed:
            return True
        with self._conns_mu:
            return bool(self._features.get(id(sock), 0) & needed)

    def close_connections(self):
        """stop() must QUIESCE: shutting down the accept loop alone leaves
        persistent handler connections serving deposits into windows the
        owner now believes are frozen."""
        with self._conns_mu:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class WindowServer:
    """Expose this process's windows for remote one-sided access.

    ``WindowServer().start()`` binds (default: an ephemeral port on all
    interfaces) and serves deposits and reads on daemon threads.  The
    address to hand to peers is ``.address``.  Serves the native window
    table, or its Python twin under ``BLUEFOG_TPU_TORCH_NO_NATIVE=1``.

    ``snapshots`` selects the :class:`~bluefog_tpu_torch.serving.snapshots.
    SnapshotTable` this server's SNAPSHOT/SUBSCRIBE ops serve: the
    process-global table by default; a relay passes its own, so one
    process can host a trainer's table and a relay's re-published groups
    on separate ports.  ``delta`` configures the push senders' op-10 delta
    cadence (:class:`~bluefog_tpu_torch.runtime.delta.DeltaConfig`)."""

    def __init__(self, *, snapshots=None, delta=None):
        self._ops = _table_ops()
        self._server: Optional[_Server] = None
        self._thread: Optional[threading.Thread] = None
        self._snapshots = snapshots
        self._delta = delta

    def start(self, host: str = "0.0.0.0", port: int = 0) -> Tuple[str, int]:
        if self._server is not None:
            raise RuntimeError("server already running")
        self._server = _Server((host, port), _Handler)
        self._server.ops = self._ops  # type: ignore[attr-defined]
        if self._snapshots is not None:
            self._server.snap_table = self._snapshots
        if self._delta is not None:
            self._server.delta_cfg = self._delta
        # a short poll: stop() waits for the accept loop's next poll
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            daemon=True)
        self._thread.start()
        return self.address

    @property
    def address(self) -> Tuple[str, int]:
        """``(host, port)`` for peers.  A wildcard bind is substituted with
        a routable address of this host (peers cannot connect to
        ``0.0.0.0``); pass an explicit ``host`` to ``start`` to control
        exactly what is advertised."""
        assert self._server is not None, "server not started"
        host, port = self._server.server_address[:2]
        if host in ("0.0.0.0", "::"):
            host = _routable_host()
        return host, port

    @property
    def snapshots(self) -> _snap.SnapshotTable:
        """The snapshot table this server serves."""
        if self._server is not None:
            return self._server.snap_table
        return (self._snapshots if self._snapshots is not None
                else _snap.table())

    def set_delta(self, cfg: _delta.DeltaConfig) -> None:
        """Install a new delta cadence (a whole-config swap; push senders
        read it fresh per push).  The tree control plane calls this at its
        round-boundary actuation."""
        self._delta = cfg
        if self._server is not None:
            self._server.delta_cfg = cfg

    def set_fanout_limit(self, limit: Optional[int]) -> None:
        """Cap live subscriptions (None = unlimited): the TreePlan's degree
        knob; over-limit SUBSCRIBEs are refused retriably (``ERR_BUSY``)."""
        if self._server is not None:
            self._server.sub_limit = (None if limit is None
                                      else max(1, int(limit)))

    @property
    def drain_deposits(self) -> int:
        """Drain-flagged deposits (graceful leavers' mass handoffs) this
        server applied: the owner-side evidence that a handoff landed."""
        return self._server.drain_deposits if self._server else 0

    @property
    def deduped_batches(self) -> int:
        """Replayed batches this server had already applied and consumed
        without applying again (the server half of exactly once)."""
        return self._server.deduped_batches if self._server else 0

    def drop_next_acks(self, n: int = 1) -> None:
        """Fault drill: apply the next ``n`` deposit batches but cut the
        connection instead of acking them, the applied-but-unacked case
        a resuming :class:`DepositStream` must replay without a double
        apply."""
        assert self._server is not None, "server not started"
        with self._server._conns_mu:
            self._server._ack_drops += int(n)

    def stop(self) -> None:
        """Quiesce: stop accepting and close live peer connections, so no
        deposit can land after stop() returns."""
        if self._server is not None:
            self._server.shutdown()
            self._server.close_connections()
            self._server.server_close()
            if self._thread is not None:
                self._thread.join(timeout=10)
            self._server = None
            self._thread = None


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------


class RemoteWindow:
    """Synchronous client handle to a window served by another host's
    :class:`WindowServer` — ``deposit`` is ``MPI_Put``/``MPI_Accumulate``
    across hosts, ``read_self`` the passive ``win_get``.  One persistent
    connection per handle; NOT thread-safe (one handle per rank thread,
    like an MPI endpoint).  For hot deposit paths prefer
    :class:`PipelinedRemoteWindow`, which overlaps the wire with compute.

    Every operation runs under a per-op DEADLINE (``timeout_s``): a
    wedged owner surfaces as a loud :class:`TimeoutError` naming the op,
    never an indefinitely hung reader thread.  ``retry=`` (``True`` for
    the defaults, or a dict of :class:`~bluefog_tpu.runtime.resilience.
    Backoff` kwargs) additionally reconnects and retries the
    *idempotent* ops — ``read_self``, a non-consuming ``read`` and an
    overwriting ``deposit(accumulate=False)``, which writes the same
    slot to the same value however often it lands — under a bounded
    backoff; a consuming ``read`` and an accumulating ``deposit`` are
    never silently re-issued (a retried consume whose first reply died
    would silently drop the consumed mass, and a retried accumulate
    would double-apply).  When the budget exhausts
    (or a non-retriable op fails), the error LATCHES like a
    :class:`DepositStream`'s: every later call on this handle raises it
    immediately instead of re-hammering a dead owner."""

    def __init__(self, address: Tuple[str, int], name: str,
                 timeout_s: float = 30.0, *, retry=None):
        self.name = name
        self._name_b = name.encode()
        self._addr = (address[0], int(address[1]))
        self._timeout_s = float(timeout_s)
        self._retry_cfg = (dict(retry) if isinstance(retry, dict)
                           else ({} if retry else None))
        self._err: Optional[str] = None
        self._sock = self._connect()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._addr,
                                        timeout=self._timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the connect timeout persists as the PER-OP deadline: recv on a
        # wedged owner raises instead of parking this thread forever
        sock.settimeout(self._timeout_s)
        return sock

    def _reconnect(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = self._connect()

    def _fail(self, msg: str) -> None:
        if self._err is None:
            self._err = msg
        _bb.record("tcp_sync_error", window=self.name, error=msg[:200])

    def _raise_if_err(self) -> None:
        if self._err is not None:
            raise RuntimeError(
                f"sync window client for {self.name!r} failed earlier "
                f"and is latched: {self._err}")

    def _roundtrip(self, op: int, slot: int, flags: int, dtype_id: int,
                   n_elems: int, payload_view=None, *,
                   recv_array: bool = False):
        pre = (_HDR.pack(_MAGIC, op, len(self._name_b)) + self._name_b +
               _BODY.pack(slot, flags, dtype_id, n_elems))
        views = [pre] if payload_view is None else [pre, payload_view]
        _sendmsg_all(self._sock, views)
        (rc,) = _STATUS.unpack(_recv_exact(self._sock, _STATUS.size))
        if rc < 0 or not recv_array:
            return rc, None
        dtype, got = _SELF_HDR.unpack(
            _recv_exact(self._sock, _SELF_HDR.size))
        # the reply's claimed geometry is bounded by the REQUEST's own
        # n_elems before anything is allocated: a lying
        # owner must not choose this client's allocation size
        if dtype not in _DTYPES or got < 0 or got > n_elems:
            raise ConnectionError(
                f"reply header out of bounds (dtype id {dtype}, "
                f"{got} elems vs {n_elems} requested)")
        # single-allocation receive: the destination array IS the receive
        # buffer (no intermediate bytes + frombuffer().copy())
        out = np.empty(got, _DTYPES[dtype])
        _recv_into(self._sock, memoryview(out).cast("B"))
        return rc, out

    def _request(self, op: int, slot: int, flags: int, dtype_id: int,
                 n_elems: int, payload_view=None, *,
                 recv_array: bool = False, idempotent: bool = False):
        self._raise_if_err()
        op_desc = {_OP_DEPOSIT: "deposit", _OP_GET_SELF: "read_self",
                   _OP_READ_SLOT: "read"}.get(op, f"op{op}")
        try:
            return self._roundtrip(op, slot, flags, dtype_id, n_elems,
                                   payload_view, recv_array=recv_array)
        except (TimeoutError, ConnectionError, OSError) as e:
            first = e
        if idempotent and self._retry_cfg is not None:
            # a timed-out or torn reply leaves the connection desynced:
            # every retry starts from a FRESH connection, under the
            # bounded backoff — reads are pure, so re-issuing is safe
            bo = resilience.read_backoff(self._retry_cfg)
            last: BaseException = first
            for delay in bo:
                _bb.record("torn_read_retry", window=self.name,
                           op=op_desc, error=str(last)[:200])
                _mt.inc("bf_read_retries_total", 1.0, op=op_desc)
                time.sleep(delay)
                try:
                    self._reconnect()
                    return self._roundtrip(op, slot, flags, dtype_id,
                                           n_elems, payload_view,
                                           recv_array=recv_array)
                except (TimeoutError, ConnectionError, OSError) as e2:
                    last = e2
            self._fail(f"{op_desc} retry budget exhausted after "
                       f"{bo.attempts} attempt(s): {last}")
            self._raise_if_err()
        if isinstance(first, TimeoutError):
            self._fail(f"{op_desc} deadline ({self._timeout_s}s) "
                       "expired — the owner is wedged or unreachable")
            raise TimeoutError(
                f"remote {op_desc} of {self.name!r} timed out after "
                f"{self._timeout_s}s (wedged owner?)") from first
        self._fail(f"connection lost mid-{op_desc}: {first}")
        raise ConnectionError(
            f"window server for {self.name!r} closed the connection "
            "mid-request (server stopped, or a protocol version "
            "mismatch — v1 servers drop unrecognized v2 frames)"
        ) from first

    def deposit(self, slot: int, arr: np.ndarray, *,
                accumulate: bool = True) -> int:
        a = np.ascontiguousarray(arr)
        if a.dtype not in _DTYPE_IDS:
            raise TypeError(f"RemoteWindow supports f32/f64, got {a.dtype}")
        rc, _ = self._request(_OP_DEPOSIT, slot,
                              _FLAG_ACCUMULATE if accumulate else 0,
                              _DTYPE_IDS[a.dtype], a.size,
                              memoryview(a).cast("B"),
                              idempotent=not accumulate)
        if rc < 0:
            raise RuntimeError(
                f"remote deposit into {self.name!r}[{slot}] failed ({rc}): "
                + _err_text(rc))
        _mt.inc("bf_tcp_single_deposits_total", 1.0)
        return rc

    def read_self(self, n_elems: int, dtype=np.float64) -> np.ndarray:
        rc, out = self._request(_OP_GET_SELF, 0, 0,
                                _DTYPE_IDS[np.dtype(dtype)], n_elems,
                                recv_array=True, idempotent=True)
        if rc < 0:
            raise RuntimeError(
                f"remote read_self of {self.name!r} failed ({rc}): "
                + _err_text(rc))
        return out

    def read(self, slot: int, n_elems: int, dtype=np.float64, *,
             consume: bool = True) -> Tuple[np.ndarray, int]:
        rc, out = self._request(_OP_READ_SLOT, slot, 1 if consume else 0,
                                _DTYPE_IDS[np.dtype(dtype)], n_elems,
                                recv_array=True, idempotent=not consume)
        if rc < 0:
            raise RuntimeError(
                f"remote read of {self.name!r}[{slot}] failed ({rc}): "
                + _err_text(rc))
        return out, rc

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class _Item:
    __slots__ = ("name_b", "slot", "flags", "dtype_id", "codec", "n_elems",
                 "views", "wire_bytes", "pooled", "tctx", "t_enq")

    def __init__(self, name_b, slot, flags, dtype_id, codec, n_elems,
                 views, wire_bytes, pooled, tctx=None, t_enq=0.0):
        self.name_b = name_b
        self.slot = slot
        self.flags = flags
        self.dtype_id = dtype_id
        self.codec = codec
        self.n_elems = n_elems
        self.views = views
        self.wire_bytes = wire_bytes
        self.pooled = pooled  # buffer to return to the pool after send
        self.tctx = tctx      # (trace_id, span_id, round) of the caller
        self.t_enq = t_enq    # perf_counter at enqueue (enqueue span)


_LOOPBACK_HOSTS = ("127.0.0.1", "::1", "localhost")


def _is_local_host(host: str) -> bool:
    """True when ``host`` names THIS machine — the co-location test of
    the same-host shm fast path.  Loopback spellings are local by
    definition; otherwise the host must equal this machine's hostname or
    one of its resolved addresses.  Resolution failures return False
    (detection failure = TCP, never an error)."""
    if host in _LOOPBACK_HOSTS or host.startswith("127."):
        return True
    try:
        names = {socket.gethostname(), socket.getfqdn()}
        if host in names:
            return True
        addrs = set()
        for n in names:
            try:
                addrs.update(info[4][0]
                             for info in socket.getaddrinfo(n, None))
            except OSError:
                pass
        if host in addrs:
            return True
    except OSError:
        return False
    # hostname resolution often maps only to loopback while the server
    # publishes its interface address: the authoritative test is a bind
    # probe — an OS will only bind a socket to one of ITS OWN addresses
    try:
        infos = socket.getaddrinfo(host, None, type=socket.SOCK_DGRAM)
    except OSError:
        return False
    for family, stype, proto, _, sockaddr in infos[:4]:
        try:
            s = socket.socket(family, stype, proto)
        except OSError:
            continue
        try:
            s.bind((sockaddr[0], 0))
            return True
        except OSError:
            continue
        finally:
            s.close()
    return False


class _LocalWindowRef:
    """Same-process twin of an shm attach: the target window already
    lives in THIS process's native table (the owner and the depositor
    are the same process — unit tests, single-host self-loops), where a
    second ``bf_win_attach_shm`` mapping is refused.  Deposits go
    straight through the table by name; geometry comes from
    ``bf_win_info`` so the fast path keeps the same dtype/size guard as
    the attached case."""

    def __init__(self, name: str):
        lib = _native.load()
        ns = ctypes.c_int()
        ne = ctypes.c_longlong()
        dt = ctypes.c_int()
        if lib.bf_win_info(name.encode(), ctypes.byref(ns),
                           ctypes.byref(ne), ctypes.byref(dt)) != 0:
            raise RuntimeError(f"window {name!r} not in the local table")
        self._lib = lib
        self.name = name
        self.n_slots = ns.value
        self.n_elems = int(ne.value)
        self.dtype = np.dtype(np.float64 if dt.value == 1 else np.float32)

    def deposit_async(self, slot: int, arr: np.ndarray, *,
                      accumulate: bool = True, copy: bool = True,
                      drain: bool = False) -> int:
        del copy  # applied before return, signature parity only
        a = np.ascontiguousarray(arr, dtype=self.dtype).ravel()
        v = self._lib.bf_win_deposit(
            self.name.encode(), slot, a.ctypes.data, self.n_elems,
            1 if accumulate else 0)
        if v < 0:
            raise RuntimeError(
                f"deposit into {self.name!r}[{slot}] failed")
        if drain:
            _mt.inc("bf_drain_deposits_total", 1.0, peer="local")
            _bb.record("drain_deposit", window=self.name, slot=slot,
                       peer="local")
        return int(v)


class DepositStream:
    """Per-peer pipelined deposit engine: fire-and-forget deposits into any
    of a peer's windows through one background sender with a bounded
    in-flight window, the userspace analog of MPI's progress thread
    servicing ``win_put``/``win_accumulate`` while the training thread
    computes.

    - :meth:`deposit_async` enqueues and returns immediately (by default it
      snapshots the payload, so callers may reuse their buffer; the
      async-DSGD hot loop does).  The sender thread coalesces everything
      queued, across windows, into one batched wire frame per send (one
      ack), keeps at most ``max_in_flight`` batches unacknowledged, and
      reports transport errors at the next call or at :meth:`flush`.
    - :meth:`flush` is the fence: it returns only when every enqueued
      deposit has been acknowledged as applied by the serving host.  Any
      loop whose correctness audit assumes "no deposit lands after X"
      (the async-DSGD mass audit barrier) must flush before X.

    One stream per (client process, peer host): every window bound for the
    same peer should share it, so a round's deposits ride one frame.
    Optional wire compression (``codec="f32"`` / ``"topk"``) is negotiated
    at connect; lossy codecs are opt-in and must not be used on payloads
    whose exact mass matters (push-sum ``p``).  Not thread-safe for
    concurrent producers (one stream per rank thread).

    Fault tolerance (``reconnect=``): a broken connection does not latch
    a terminal error at once; the sender reconnects with exponential
    backoff and jitter under a retry budget
    (:class:`~bluefog_tpu_torch.runtime.resilience.Backoff`; pass
    ``True`` for the defaults or a dict of Backoff kwargs), re-attaches
    its stream lineage (STREAM_ATTACH carries a stable stream id and a
    fresh epoch), and replays the unacked in-flight batches.  The attach
    reply is the server's applied high-water mark, so a batch that was
    applied but unacked when the connection died is retired instead of
    re-sent, and the server dedups by the same mark: replay is
    idempotent end to end.  Only when the budget is exhausted does the
    stream latch the error and mark the peer DEAD (:attr:`health`).
    ``heartbeat_interval_s > 0`` also probes an idle stream with the
    HEARTBEAT wire op, so peer health does not go stale between deposits.

    Same-host shm route (``shm=True``): when the peer address names this
    machine, deposits go through the named-shm window table
    (``AsyncWindow(attach=True)``, or the process-local table when owner
    and depositor share a process) instead of the wire: one mutex-guarded
    memory accumulate, no frame, no ack.  The first attach failure (the
    owner's windows are not shm-backed, a remote host) routes everything
    over TCP; a per-window geometry mismatch or an shm fault falls back
    for that window only.  Routing is sticky per window name, so a
    window's deposits never reorder across transports; :attr:`shm_deposits`
    counts the deposits that took the table.  An shm deposit is applied
    when :meth:`deposit_async` returns, so :meth:`flush` still fences
    exactly the deposits on the wire.  Health and heartbeats keep riding
    TCP: the liveness of the peer process is a wire question."""

    def __init__(self, address: Tuple[str, int],
                 timeout_s: float = 30.0, *, codec: Optional[str] = None,
                 topk_ratio: float = 0.1, max_in_flight: int = 4,
                 max_queue_items: int = 1024,
                 max_batch_bytes: int = 16 << 20,
                 reconnect=None,
                 heartbeat_interval_s: float = 0.0,
                 suspect_after_s: float = 2.0,
                 dead_after_s: float = 20.0,
                 shm: bool = False,
                 on_ewma: Optional[Callable[[float], None]] = None):
        self._addr = (address[0], int(address[1]))
        self._peer = f"{address[0]}:{address[1]}"
        self._timeout_s = float(timeout_s)
        self._codec = wire_codec.CODEC_IDS[codec or "none"]
        # the negotiation ceiling: HELLO requests this codec's feature
        # bit plus every less aggressive one, so set_codec() can walk
        # the whole ladder at or below it after connect
        self._codec_max = self._codec
        self._topk_ratio = float(topk_ratio)
        self._max_in_flight = max(1, int(max_in_flight))
        self._max_queue = max(1, int(max_queue_items))
        # coalescing cap: without it a fast producer collapses the whole
        # queue into one frame and the pipeline degenerates to
        # stop-and-wait at frame granularity; several bounded frames in
        # flight keep client send, server recv and server apply overlapped
        self._max_batch_bytes = max(1 << 16, int(max_batch_bytes))
        # ------------------------------------------------------ tracing
        # the arming decision is taken once, at construction (when the
        # codec ceiling is fixed too): a stream built while tracing is
        # armed asks for FEATURE_TRACE at every HELLO it sends, so replay
        # frames parse like first sends.  A server that does not grant it
        # degrades the connection silently, never fails the handshake.
        self._trace_want = _tr.get() is not None
        self._trace_on = False
        # --------------------------------------------------- resilience
        self._resume = bool(reconnect)
        self._reconnect_cfg = (dict(reconnect)
                               if isinstance(reconnect, dict) else {})
        self._hb_interval = float(heartbeat_interval_s)
        self._hb_last = time.monotonic()
        self._hb_seq = 0
        self._hb_sent: Dict[int, float] = {}
        self.health: Optional[resilience.PeerHealth] = (
            resilience.PeerHealth(self._peer,
                                  suspect_after_s=suspect_after_s,
                                  dead_after_s=dead_after_s)
            if (self._resume or self._hb_interval > 0) else None)
        # stable lineage id + per-connection epoch (see STREAM_ATTACH)
        self._stream_id = int.from_bytes(os.urandom(8), "little") or 1
        self._epoch = 0
        self._flushes = 0  # the recorder's flush span keys
        self._sock_gen = 0
        self._conn_broken = False
        self._wake = threading.Event()  # interrupts backoff sleeps on close
        self._cv = _lc.condition("runtime.window_server.DepositStream._cv")
        self._queue: collections.deque = collections.deque()
        # seq -> (t_send, retained items | None); items are retained until
        # the ack only when reconnect is on: they are the replay window
        self._inflight: Dict[int, Tuple] = {}
        self._seq = 0
        self._err: Optional[str] = None
        self._closed = False
        self._pool: Dict[Tuple[int, int], List[np.ndarray]] = {}
        # recent (send -> ack) latencies in seconds
        self.ack_latencies: collections.deque = collections.deque(
            maxlen=4096)
        # per-peer ack-latency EWMA, heartbeat RTTs folded in, so an idle
        # stream's evidence does not go stale.  Written by the ack
        # thread, read by the producer: a float store is atomic under
        # the GIL.
        self._ack_ewma: Optional[float] = None
        self._ack_ewma_alpha = 0.2
        # per-peer phase EWMAs (net / owner queue / owner apply seconds)
        # from the extended batch acks of FEATURE_TRACE connections: the
        # evidence that tells the control plane a slow link from a slow
        # host.  None until the first timed ack (or for good, with
        # tracing off).  Written by the ack thread only.
        self._phase_ewma: Optional[Tuple[float, float, float]] = None
        # striping hook: a StripedDepositStream rolls its stripes' EWMAs
        # up into one per-peer value (max of stripes)
        self._on_ewma = on_ewma
        self._reconnects = 0
        # exactly-once bookkeeping of the reconnects: batches the attach
        # reply retired (applied, their ack lost) and batches re-sent
        self.retired_batches = 0
        self.replayed_batches = 0
        # bytes this stream put on the wire
        self.wire_bytes = 0
        # ------------------------------------------------ shm route
        # co-location is decided once per stream (cheap address test);
        # capability (shm-backed windows on the owner) is probed at the
        # first deposit and latched, see _shm_window
        self._shm_ok = bool(shm) and _is_local_host(self._addr[0])
        if shm and not self._shm_ok:
            _bb.record("shm_fallback", peer=self._peer, window="*",
                       reason="peer host is not local")
        self._shm_wins: Dict[bytes, Optional[object]] = {}
        self._shm_deposits = 0
        self._sock = self._connect_first()
        self._sender = threading.Thread(
            target=self._send_loop, daemon=True,
            name=f"bf-win-send:{self._peer}")
        self._acker = threading.Thread(
            target=self._ack_loop, daemon=True,
            name=f"bf-win-ack:{self._peer}")
        self._sender.start()
        self._acker.start()

    # --------------------------------------------------------- connection
    def _backoff(self) -> "resilience.Backoff":
        return resilience.Backoff(**{**dict(base_s=0.05, cap_s=2.0,
                                            factor=2.0, jitter=0.5,
                                            budget=8),
                                     **self._reconnect_cfg})

    def _connect_first(self) -> socket.socket:
        """The first connect.  A resuming stream gives it the reconnect
        budget, since a lossy link cuts a HELLO or a STREAM_ATTACH as it
        cuts any later frame; a handshake rejection stays terminal."""
        try:
            return self._connect_once(self._timeout_s)
        except (OSError, ConnectionError) as e:
            if not self._resume:
                raise
            last: BaseException = e
        bo = self._backoff()
        for delay in bo:
            time.sleep(delay)
            try:
                return self._connect_once(self._timeout_s)
            except (OSError, ConnectionError) as e:
                last = e
        raise ConnectionError(
            f"window server at {self._peer} unreachable: connect budget "
            f"exhausted after {bo.attempts} attempt(s): {last}") from last

    def _connect_once(self, timeout_s: float) -> socket.socket:
        """One connect + HELLO (+ STREAM_ATTACH when resuming).  Raises
        on any failure.  On a resumed stream the attach reply retires
        every in-flight batch the server already applied, the
        idempotence half of reconnect replay."""
        sock = socket.create_connection(self._addr, timeout=timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # request the ceiling codec's feature bit and every rung
            # below it, so a mid-run set_codec() step-down never needs a
            # renegotiation, and the want is stable across reconnects
            want = FEATURE_BATCH
            for cid, bit in _CODEC_FEATURE.items():
                if cid <= self._codec_max:
                    want |= bit
            if self._resume:
                want |= FEATURE_RESUME
            if self._hb_interval > 0:
                want |= FEATURE_HEARTBEAT
            if self._trace_want:
                want |= FEATURE_TRACE
            _sendmsg_all(sock, [
                _HDR.pack(_MAGIC, _OP_HELLO, 0),
                _HELLO.pack(PROTOCOL_VERSION, want)])
            (granted,) = _STATUS.unpack(_recv_exact(sock, _STATUS.size))
            if granted < 0:
                raise RuntimeError(
                    f"window server at {self._peer} rejected the v"
                    f"{PROTOCOL_VERSION} handshake ({granted}): "
                    + _err_text(int(granted)))
            if want & ~granted & ~FEATURE_TRACE:
                # FEATURE_TRACE is the one optional want: a server that
                # cannot carry trace headers still serves deposits, and
                # tracing degrades silently on this connection
                raise RuntimeError(
                    f"window server at {self._peer} does not support the "
                    f"requested transport features (want {want:#x}, "
                    f"granted {int(granted):#x})")
            self._trace_on = bool(self._trace_want
                                  and granted & FEATURE_TRACE)
            if self._resume:
                self._epoch += 1
                _sendmsg_all(sock, [
                    _HDR.pack(_MAGIC, _OP_STREAM_ATTACH, 0),
                    _ATTACH.pack(self._stream_id, self._epoch)])
                (applied,) = _STATUS.unpack(
                    _recv_exact(sock, _STATUS.size))
                if applied == _ERR_BUSY:
                    # old generation still draining: retryable, surfaced
                    # as a connection-level condition so the backoff
                    # loop tries again
                    raise ConnectionError(
                        f"stream attach to {self._peer} deferred: "
                        + _err_text(_ERR_BUSY))
                if applied < 0:
                    # terminal: a latched batch error (a deposit this
                    # stream sent was rejected; the ack died with the
                    # old connection) or a superseded epoch
                    raise RuntimeError(
                        f"stream attach to {self._peer} rejected "
                        f"({int(applied)}): " + _err_text(int(applied)))
                self._retire_through(int(applied))
            # connect/HELLO/attach honoured timeout_s; the steady-state
            # stream must not: the ack reader's recv legitimately sits
            # idle for as long as the training loop goes without
            # depositing
            sock.settimeout(None)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return sock

    def _retire_through(self, applied_seq: int) -> None:
        """Drop in-flight batches the server reports as applied (they
        were applied but unacked when the old connection died)."""
        with self._cv:
            for s in [s for s in self._inflight if s <= applied_seq]:
                self.retired_batches += 1
                entry = self._inflight.pop(s)
                for it in entry[1] or ():
                    if it.pooled is not None:
                        self._give(it.pooled)
                if entry[2] is not None:
                    # applied but unacked, resolved by the attach mark:
                    # the wire span ends here, marked so the analyzer
                    # knows its duration includes the outage
                    entry[2].finish(retired=True)
            self._cv.notify_all()

    def _frame_views(self, seq: int, items: List["_Item"],
                     tctx=None) -> List:
        views: List = [_HDR.pack(_MAGIC, _OP_DEPOSIT_BATCH, 0),
                       _BATCH_HDR.pack(seq, len(items))]
        if self._trace_on:
            # the wire-propagated causal context: on every batch frame of
            # a FEATURE_TRACE connection (span_id 0 = no active span: the
            # server parses, then ignores), right after the frame header
            tid, sid, rnd = tctx or (0, 0, 0)
            views.insert(1, _TRACE_HDR.pack(tid, sid, rnd))
        for it in items:
            views.append(_ITEM.pack(
                len(it.name_b), it.slot, it.flags, it.dtype_id,
                it.codec, it.n_elems, it.wire_bytes))
            views.append(it.name_b)
            views.extend(it.views)
        return views

    def _recover(self, reason: str) -> bool:
        """Reconnect with bounded backoff and jitter and replay the
        unacked in-flight window.  True when the stream is live again;
        False after latching the terminal error (budget exhausted or the
        stream is closing): the peer is then DEAD."""
        if not self._resume or self._closed:
            return False
        h = self.health
        if h is not None:
            h.note_failure()
        _bb.record("tcp_reconnect", peer=self._peer, reason=reason[:200],
                   inflight=len(self._inflight))
        try:
            self._sock.close()
        except OSError:
            pass
        bo = self._backoff()
        for delay in bo:
            _mt.observe("bf_reconnect_backoff_seconds", delay,
                        peer=self._peer)
            if self._wake.wait(delay) or self._closed:
                return False
            try:
                sock = self._connect_once(self._timeout_s)
            except (OSError, ConnectionError):
                if h is not None:
                    h.note_failure()
                continue
            except RuntimeError as e:
                # handshake/attach rejection (version, features, a
                # latched batch error, a superseded epoch): terminal;
                # burning the rest of the budget would only relabel the
                # real error as "peer unreachable"
                self._fail(str(e))
                return False
            # replay what the attach reply left outstanding, in seq
            # order; the server dedups anything a zombie raced in
            with self._cv:
                pending = sorted(self._inflight.items())
            try:
                for seq, entry in pending:
                    wsp = entry[2]
                    _sendmsg_all(sock, self._frame_views(
                        seq, entry[1],
                        wsp.ctx if wsp is not None else None))
            except (OSError, ConnectionError):
                try:
                    sock.close()
                except OSError:
                    pass
                if h is not None:
                    h.note_failure()
                continue
            with self._cv:
                if self._closed:
                    # close() won the race while we were connecting: it
                    # already closed (or is about to close) the old
                    # socket it read; installing the fresh one would leak
                    # it and park the ack thread in recv forever
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return False
                self._sock = sock
                self._sock_gen += 1
                self._conn_broken = False
                self._cv.notify_all()
            self._hb_last = time.monotonic()
            self._reconnects += 1
            self.replayed_batches += len(pending)
            _mt.inc("bf_reconnects_total", 1.0, peer=self._peer)
            if pending:
                _mt.inc("bf_replayed_batches_total", float(len(pending)),
                        peer=self._peer)
            _bb.record("tcp_reconnected", peer=self._peer,
                       epoch=self._epoch, replayed=len(pending))
            if h is not None:
                h.note_ok()
            return True
        if h is not None:
            h.mark_dead("reconnect budget exhausted")
        self._fail(f"peer unreachable ({reason}); reconnect budget "
                   f"exhausted after {bo.attempts} attempt(s)")
        return False

    def _heartbeat(self) -> bool:
        """Probe an idle stream's liveness (HEARTBEAT wire op); the reply
        rides the ack channel with the high bit set."""
        self._hb_seq = (self._hb_seq + 1) & 0x7FFF_FFFF
        seq = self._hb_seq
        self._hb_sent[seq] = time.perf_counter()
        while len(self._hb_sent) > 64:
            self._hb_sent.pop(next(iter(self._hb_sent)))
        self._hb_last = time.monotonic()
        views: List = [_HDR.pack(_MAGIC, _OP_HEARTBEAT, 0), _HB.pack(seq)]
        if self._trace_on:
            # HEARTBEAT is a traced op: the header rides along (empty: an
            # idle probe has no active span), so the server's frame parse
            # stays deterministic per connection
            views.insert(1, _TRACE_HDR.pack(0, 0, 0))
        try:
            _sendmsg_all(self._sock, views)
        except (OSError, ConnectionError) as e:
            if self._resume:
                return self._recover(f"heartbeat send failed: {e}")
            self._fail(f"heartbeat send failed: {e}")
            return False
        return True

    # ------------------------------------------------------------ producer
    def _take(self, dtype: np.dtype, n: int) -> np.ndarray:
        key = (_DTYPE_IDS[dtype], n)
        free = self._pool.get(key)
        if free:
            return free.pop()
        return np.empty(n, dtype)

    def _give(self, arr: np.ndarray) -> None:
        key = (_DTYPE_IDS[arr.dtype], arr.size)
        free = self._pool.setdefault(key, [])
        if len(free) < self._max_in_flight * 2 + 2:
            free.append(arr)

    def _raise_if_err(self) -> None:
        if self._err is not None:
            raise RuntimeError(
                f"pipelined deposits to {self._peer} failed: {self._err}")

    # ------------------------------------------------------ wire telemetry
    def _note_latency(self, seconds: float) -> None:
        prev = self._ack_ewma
        a = self._ack_ewma_alpha
        ewma = seconds if prev is None else (a * seconds + (1.0 - a) * prev)
        self._ack_ewma = ewma
        if self._on_ewma is not None:
            self._on_ewma(ewma)
        else:
            _mt.set("bf_peer_ack_ewma_seconds", ewma, peer=self._peer)

    def ack_ewma(self) -> Optional[float]:
        """EWMA (seconds) over this peer's deposit-ack latencies and
        heartbeat RTTs, the programmatic slow-peer signal.  None until
        the first ack or heartbeat reply arrives."""
        return self._ack_ewma

    def _note_phases(self, wsp, times, lat: float, seq: int) -> None:
        """Ack-thread bookkeeping for one traced batch: finish the wire
        span (with the owner's ``queue_s`` and ``apply_s`` the extended
        ack carried), emit the ``ack_wait`` child span, and fold the
        (net, queue, apply) split into the phase EWMA that
        :meth:`phase_ewma` returns."""
        extra = {}
        if times is not None:
            queue_s, apply_s = times[0] / 1e6, times[1] / 1e6
            extra = {"queue_s": queue_s, "apply_s": apply_s}
            net = max(0.0, lat - queue_s - apply_s)
            prev = self._phase_ewma
            a = self._ack_ewma_alpha
            if prev is None:
                self._phase_ewma = (net, queue_s, apply_s)
            else:
                self._phase_ewma = (
                    a * net + (1.0 - a) * prev[0],
                    a * queue_s + (1.0 - a) * prev[1],
                    a * apply_s + (1.0 - a) * prev[2])
        trec = _tr.get()
        if trec is not None:
            # send_s may not be written yet when the ack beat the
            # sender's bookkeeping after sendall; clamp into [0, lat]
            send_s = min(lat, float(wsp.fields.get("send_s", 0.0) or 0.0))
            trec.emit("ack_wait", "tcp", t0=wsp.t0 + send_s,
                      dur=max(0.0, lat - send_s), parent=wsp.sid,
                      round_=wsp.round, trace_id=wsp.tid,
                      peer=self._peer, seq=seq)
        wsp.finish(**extra)

    def phase_ewma(self) -> Optional[Dict[str, float]]:
        """This peer's wire-phase EWMA, ``{"net": s, "queue": s, "apply":
        s}``: its ack latency split into network and front end, the
        owner's queue wait and the owner's apply (the slow-link against
        slow-host evidence, :class:`~bluefog_tpu_torch.control.evidence.
        Evidence` ``phase_s``).  None until a FEATURE_TRACE connection
        delivered a timed ack."""
        p = self._phase_ewma
        if p is None:
            return None
        return {"net": p[0], "queue": p[1], "apply": p[2]}

    @property
    def reconnects(self) -> int:
        """Completed reconnect-and-replay cycles on this stream."""
        return self._reconnects

    def set_codec(self, codec: Optional[str]) -> None:
        """Retune wire compression at a round boundary: later
        :meth:`deposit_async` calls encode with ``codec`` (``None`` /
        ``"none"``, ``"f32"``, ``"topk"``).  The stream negotiates the
        feature bits of its construction codec and every less aggressive
        one at HELLO, so it can step anywhere at or below that ceiling,
        never above it.  Call from the producer thread only."""
        want = wire_codec.CODEC_IDS[codec or "none"]
        if want > self._codec_max:
            raise ValueError(
                f"codec {codec!r} exceeds the ceiling negotiated at "
                f"connect ({wire_codec.CODEC_NAMES[self._codec_max]!r}); "
                "open the stream with the most aggressive codec the run "
                "may ever use and back off from there")
        self._codec = want

    def set_max_batch_bytes(self, n: int) -> None:
        """Retune the coalescing cap at a round boundary (smaller frames
        = more frames in flight = a deeper pipeline; larger frames =
        fewer acks).  Call from the producer thread."""
        self._max_batch_bytes = max(1 << 16, int(n))

    # ----------------------------------------------------- shm route
    def _shm_window(self, name: bytes):
        """Resolve the shm route for one window name, caching the
        verdict: an attached/local window handle, or None (TCP for this
        name for good).  The first attach failure latches shm off for
        the whole stream: windows of one owner are homogeneous, and a
        per-name probe against a non-shm owner would pay the attach
        timeout once per window."""
        if name in self._shm_wins:
            return self._shm_wins[name]
        win = None
        try:
            from bluefog_tpu_torch.runtime.async_windows import AsyncWindow
            if (_native.enabled()
                    and _native.load().bf_win_exists(name) == 1):
                # already open in this process: owner and depositor share
                # a table, deposit through it directly
                win = _LocalWindowRef(name.decode())
            else:
                win = AsyncWindow(name.decode(), attach=True,
                                  attach_timeout_s=1.0)
        except Exception as e:  # noqa: BLE001 — any capability failure
            # (owner's windows not shm-backed, stale geometry) means
            # TCP, never an error
            self._shm_ok = False
            _bb.record("shm_fallback", peer=self._peer,
                       window=name.decode("utf-8", "replace"),
                       reason=f"{type(e).__name__}: {e}"[:200])
        self._shm_wins[name] = win
        return win

    def _try_shm_deposit(self, name: bytes, slot: int, arr: np.ndarray,
                         *, accumulate: bool, drain: bool) -> bool:
        """Apply one deposit through the same-host shm table.  True =
        applied (exactly once, atomically under the window mutex);
        False = route this deposit over TCP instead.  A failed native
        deposit applies nothing, so recovery is re-delivery over the
        wire, still exactly once."""
        win = self._shm_window(name)
        if win is None:
            return False
        if win.dtype != arr.dtype or win.n_elems != arr.size:
            # geometry mismatch: the wire path's per-item dtype/size
            # check handles it; the table route cannot
            self._shm_wins[name] = None
            _bb.record("shm_fallback", peer=self._peer,
                       window=name.decode("utf-8", "replace"),
                       reason="dtype/size mismatch")
            return False
        act = _chaos.fire("client", peer=self._peer, seq=-1, shm=1)
        if act is not None:
            if act[0] in ("delay", "stall"):
                time.sleep(act[1])
            else:
                # drop or truncate: the shm write tore before the atomic
                # table accumulate, so nothing applied; the deposit is
                # re-delivered over TCP, still exactly once
                self._shm_wins[name] = None
                _bb.record("shm_fallback", peer=self._peer,
                           window=name.decode("utf-8", "replace"),
                           reason=f"chaos:{act[0]}")
                return False
        try:
            win.deposit_async(slot, arr, accumulate=accumulate,
                              drain=drain)
        except Exception as e:  # noqa: BLE001 — fall back, exactly once
            self._shm_wins[name] = None
            _bb.record("shm_fallback", peer=self._peer,
                       window=name.decode("utf-8", "replace"),
                       reason=f"{type(e).__name__}: {e}"[:200])
            return False
        self._shm_deposits += 1
        _mt.inc("bf_shm_deposits_total", 1.0, peer=self._peer)
        return True

    @property
    def shm_deposits(self) -> int:
        """Deposits this stream routed through the same-host shm table."""
        return self._shm_deposits

    def deposit_async(self, name: bytes, slot: int, arr: np.ndarray, *,
                      accumulate: bool = True, copy: bool = True,
                      drain: bool = False) -> None:
        """Enqueue one deposit into the peer's window ``name`` (bytes);
        returns immediately.  ``copy=True`` (default) snapshots ``arr``
        into a pooled buffer so the caller may overwrite it at once; pass
        ``copy=False`` only when the buffer is immutable until
        :meth:`flush` returns.  ``drain=True`` marks the deposit as a
        graceful leaver's final mass handoff (wire flag bit2; the value
        semantics are unchanged).  Errors (including those of earlier
        fire-and-forget deposits) raise here or at flush."""
        a = np.ascontiguousarray(arr)
        if a.dtype not in _DTYPE_IDS:
            raise TypeError(
                f"pipelined deposits support f32/f64, got {a.dtype}")
        a = a.reshape(-1)
        self._raise_if_err()
        if self._shm_ok and self._try_shm_deposit(
                name, slot, a, accumulate=accumulate, drain=drain):
            return  # applied: nothing in flight, nothing to fence
        # tracing: capture the caller's active span context here, on the
        # producer thread; round and parentage then ride the item into
        # the sender thread and onto the wire
        trec = _tr.get()
        tctx = _tr.current_ctx() if trec is not None else None
        t_snap_w = time.time() if trec is not None else 0.0
        t_snap_p = time.perf_counter() if trec is not None else 0.0
        pooled = None
        if self._codec == wire_codec.CODEC_NONE:
            if copy:
                pooled = self._take(a.dtype, a.size)
                np.copyto(pooled, a)
                a = pooled
            views = [memoryview(a).cast("B")]
            wire = a.nbytes
        else:
            # lossy codecs allocate fresh wire arrays; the source is free
            views, wire = wire_codec.encode(
                a, self._codec, topk_ratio=self._topk_ratio)
        flags = (_FLAG_ACCUMULATE if accumulate else 0) | (
            _FLAG_DRAIN if drain else 0)
        item = _Item(name, slot, flags, _DTYPE_IDS[a.dtype], self._codec,
                     a.size, views, wire, pooled, tctx=tctx)
        if trec is not None:
            item.t_enq = time.perf_counter()
            trec.emit("snapshot", "tcp", t0=t_snap_w,
                      dur=item.t_enq - t_snap_p,
                      parent=tctx[1] if tctx else None,
                      round_=tctx[2] if tctx else None,
                      trace_id=tctx[0] if tctx else None,
                      peer=self._peer, bytes=wire)
        t0 = time.perf_counter()
        with self._cv:
            while (len(self._queue) >= self._max_queue
                   and self._err is None and not self._closed):
                self._cv.wait(timeout=1.0)
            self._raise_if_err()
            if self._closed:
                raise RuntimeError(
                    f"DepositStream to {self._peer} is closed")
            self._queue.append(item)
            self._cv.notify_all()
        stalled = time.perf_counter() - t0
        if stalled > 0.005:
            # backpressure made the training thread wait: the signal a
            # wedged or slow peer gives first
            _mt.inc("bf_tcp_queue_stalls_total", 1.0, peer=self._peer)
            _bb.record("tcp_queue_stall", peer=self._peer,
                       waited_s=round(stalled, 6))
        if trec is not None:
            # the enqueue phase: zero when the queue had room, the
            # backpressure wait when it did not (the first place a slow
            # peer takes training-thread time)
            trec.emit("enqueue", "tcp", t0=time.time() - stalled,
                      dur=stalled,
                      parent=tctx[1] if tctx else None,
                      round_=tctx[2] if tctx else None,
                      trace_id=tctx[0] if tctx else None,
                      peer=self._peer)

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Fence: block until every enqueued deposit is acknowledged as
        applied by the serving host (or raise the transport error).  After
        ``flush`` returns, an owner-side read observes all of this
        stream's earlier deposits."""
        self._flushes += 1
        key = (self._peer, self._flushes)
        _bb.begin("tcp_flush", key=key, peer=self._peer)
        t0 = time.perf_counter()
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._err is not None or (
                    not self._queue and not self._inflight),
                timeout=timeout_s)
        waited = time.perf_counter() - t0
        _bb.end("tcp_flush", key=key, peer=self._peer,
                waited_s=round(waited, 6))
        _mt.observe("bf_tcp_flush_seconds", waited, peer=self._peer)
        self._raise_if_err()
        if not ok:
            raise TimeoutError(
                f"flush of pipelined deposits to {self._peer} timed out "
                f"after {timeout_s}s ({len(self._queue)} queued, "
                f"{len(self._inflight)} in flight)")

    # ------------------------------------------------------------- threads
    def _send_loop(self) -> None:
        # idle polling exists only for the resilience features: without
        # them the wait is unbounded
        poll = None
        if self._hb_interval > 0:
            poll = min(self._hb_interval / 2.0, 1.0)
        elif self.health is not None:
            poll = 1.0
        try:
            while True:
                with self._cv:
                    self._cv.wait_for(
                        lambda: self._queue or self._closed
                        or self._err is not None or self._conn_broken,
                        timeout=poll)
                    if self._err is not None:
                        return
                    broken = self._conn_broken
                    if not self._queue and not broken:
                        if self._closed:
                            return
                        idle = True
                    else:
                        idle = False
                if broken:
                    # the ack reader saw the connection die first
                    if not self._recover("connection lost"):
                        return
                    continue
                if idle:
                    if self.health is not None:
                        self.health.poll()
                    if (self._hb_interval > 0 and
                            time.monotonic() - self._hb_last
                            >= self._hb_interval):
                        if not self._heartbeat():
                            return
                    continue
                t_win = time.perf_counter()
                with self._cv:
                    while (len(self._inflight) >= self._max_in_flight
                           and self._err is None and not self._closed
                           and not self._conn_broken):
                        self._cv.wait(timeout=1.0)
                        if self.health is not None:
                            self.health.poll()
                    if self._err is not None:
                        return
                    if self._conn_broken:
                        continue  # the outer loop recovers first
                    win_stalled = time.perf_counter() - t_win
                    items = []
                    nbytes = 0
                    while self._queue and (
                            not items
                            or nbytes < self._max_batch_bytes):
                        it = self._queue.popleft()
                        items.append(it)
                        nbytes += it.wire_bytes
                    self._seq += 1
                    seq = self._seq
                    wire_total = sum(i.wire_bytes for i in items)
                    wsp = None
                    trec = _tr.get() if self._trace_on else None
                    if trec is not None:
                        # the wire span: begun here on the sender thread,
                        # finished by the ack reader when the owner's ack
                        # lands; its sid is what the trace header
                        # carries, so the owner-side recv, queue, apply
                        # and ack spans parent to it across processes
                        ictx = next((i.tctx for i in items
                                     if i.tctx is not None), None)
                        t_oldest = min(i.t_enq for i in items)
                        wsp = trec.begin_span(
                            "wire", "tcp",
                            parent=ictx[1] if ictx else None,
                            round_=ictx[2] if ictx else None,
                            trace_id=ictx[0] if ictx else None,
                            peer=self._peer, seq=seq, items=len(items),
                            bytes=wire_total,
                            dst=items[0].name_b.decode("utf-8", "replace"))
                        trec.emit("coalesce", "tcp",
                                  t0=time.time() -
                                  (time.perf_counter() - t_oldest),
                                  dur=time.perf_counter() - t_oldest,
                                  parent=wsp.sid, round_=wsp.round,
                                  trace_id=wsp.tid, peer=self._peer,
                                  seq=seq, items=len(items))
                    # items are retained until the ack when reconnect is
                    # on: they are the replay window
                    self._inflight[seq] = (
                        time.perf_counter(),
                        items if self._resume else None, wsp)
                    self._cv.notify_all()
                if win_stalled > 0.005:
                    # the in-flight window was full: the peer acks slower
                    # than this rank sends
                    _mt.inc("bf_tcp_window_stalls_total", 1.0,
                            peer=self._peer)
                    _bb.record("tcp_window_stall", peer=self._peer,
                               waited_s=round(win_stalled, 6))
                views = self._frame_views(
                    seq, items, wsp.ctx if wsp is not None else None)
                t_send0 = time.perf_counter()
                try:
                    act = _chaos.fire("client", peer=self._peer, seq=seq)
                    if act is not None:
                        if act[0] in ("delay", "stall"):
                            time.sleep(act[1])
                        elif act[0] == "truncate":
                            # a torn frame on the wire, then the cut: the
                            # server discards the partial batch and the
                            # replay delivers it exactly once
                            _sendmsg_all(self._sock,
                                         views[:max(2, len(views) // 2)])
                            raise ConnectionError("chaos: truncated frame")
                        else:
                            raise ConnectionError("chaos: dropped "
                                                  "connection")
                    _sendmsg_all(self._sock, views)
                except (OSError, ConnectionError) as e:
                    if self._resume:
                        if self._recover(
                                f"send failed: {type(e).__name__}: {e}"):
                            continue
                        return  # _recover latched the terminal error
                    raise
                if wsp is not None:
                    # the frame's time in the socket buffer: lets the ack
                    # reader split the wire span into send and ack_wait.
                    # The server can ack while sendall's last syscall is
                    # still returning, so the ack reader may not see this
                    # field yet; it then folds the whole latency into
                    # ack_wait (_note_phases clamps)
                    wsp.fields["send_s"] = round(
                        time.perf_counter() - t_send0, 9)
                self.wire_bytes += wire_total
                if not self._resume:
                    # without a replay window the snapshots are recycled
                    # as soon as the kernel took them; with one, the ack
                    # reader recycles
                    with self._cv:
                        for it in items:
                            if it.pooled is not None:
                                self._give(it.pooled)
                self._note_batch(items, wire_total)
        except Exception as e:  # noqa: BLE001 — nothing may kill the
            # sender silently: a dead sender with _err unset would block
            # every later flush() at the audit fence with no diagnostic
            self._fail(f"send failed: {type(e).__name__}: {e}")

    def _ack_loop(self) -> None:
        buf = bytearray(_ACK.size)
        mv = memoryview(buf)
        tbuf = bytearray(_ACK_TIMES.size)
        tmv = memoryview(tbuf)
        while True:
            with self._cv:
                sock = self._sock
                gen = self._sock_gen
                # the connection's negotiation decides the ack frame size;
                # read it with the socket, so a reconnect cannot desync
                # this reader's framing mid-generation
                t_on = self._trace_on
            try:
                _recv_into(sock, mv)
                seq, status = _ACK.unpack(buf)
                times = None
                if t_on and not seq & _HB_MARK:
                    # batch acks on FEATURE_TRACE connections carry the
                    # owner's (queue_us, apply_us) tail; heartbeat acks
                    # never do
                    _recv_into(sock, tmv)
                    times = _ACK_TIMES.unpack(tbuf)
            except (OSError, ConnectionError, ValueError):
                if self._closed:
                    return
                if self._resume:
                    # flag the outage and wait for the sender to swap in
                    # a reconnected socket (or give up); only the current
                    # generation's failure counts
                    with self._cv:
                        if self._sock_gen == gen:
                            self._conn_broken = True
                        self._cv.notify_all()
                        self._cv.wait_for(
                            lambda: self._sock_gen != gen or self._closed
                            or self._err is not None)
                        if self._closed or self._err is not None:
                            return
                    continue
                self._fail("connection lost before all deposits "
                           "were acknowledged")
                return
            if seq & _HB_MARK:
                t0 = self._hb_sent.pop(seq & ~_HB_MARK, None)
                if t0 is not None:
                    rtt = time.perf_counter() - t0
                    _mt.observe("bf_peer_heartbeat_rtt_seconds", rtt,
                                peer=self._peer)
                    self._note_latency(rtt)
                if self.health is not None:
                    self.health.note_ok()
                continue
            with self._cv:
                entry = self._inflight.pop(seq, None)
                if entry is not None:
                    for it in entry[1] or ():
                        if it.pooled is not None:
                            self._give(it.pooled)
                self._cv.notify_all()
            if entry is not None:
                lat = time.perf_counter() - entry[0]
                if entry[2] is not None:
                    self._note_phases(entry[2], times, lat, seq)
                self.ack_latencies.append(lat)
                self._note_latency(lat)
                _mt.observe("bf_tcp_ack_latency_seconds", lat,
                            peer=self._peer)
                _mt.set("bf_tcp_inflight_batches",
                        float(len(self._inflight)), peer=self._peer)
            if status < 0:
                self._fail(f"peer rejected a batched deposit ({status}): "
                           + _err_text(int(status)))
                return
            if self.health is not None:
                self.health.note_ok()

    def _fail(self, msg: str) -> None:
        with self._cv:
            if self._err is None:
                self._err = msg
            self._queue.clear()
            self._cv.notify_all()
        _bb.record("tcp_pipeline_error", peer=self._peer, error=msg)

    def _note_batch(self, items, wire_total: int) -> None:
        """A batch left on the wire: its counts, wire and dense bytes (the
        codec's ratio, when one is on) and the in-flight depth."""
        if _mreg.current() is None:
            return
        dense_total = sum(i.n_elems * _DTYPES[i.dtype_id].itemsize
                          for i in items)
        codec = wire_codec.CODEC_NAMES[self._codec]
        _mt.inc("bf_tcp_pipelined_batches_total", 1.0, peer=self._peer)
        _mt.inc("bf_tcp_pipelined_items_total", float(len(items)),
                peer=self._peer)
        _mt.inc("bf_tcp_wire_bytes_total", wire_total, peer=self._peer,
                codec=codec)
        _mt.inc("bf_tcp_dense_bytes_total", dense_total, peer=self._peer)
        _mt.set("bf_tcp_inflight_batches", float(len(self._inflight)),
                peer=self._peer)
        if dense_total and self._codec != wire_codec.CODEC_NONE:
            _mt.set("bf_compression_ratio", wire_total / dense_total,
                    compressor="wire_" + codec, transport="tcp")

    def close(self) -> None:
        """Close the stream.  Does not flush: callers owning an exactness
        invariant must :meth:`flush` first."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._wake.set()  # interrupt a mid-backoff reconnect sleep
        self._sender.join(timeout=5)
        # read the socket under the lock: a reconnect mid-close must not
        # swap in a fresh socket between our read and our close
        with self._cv:
            sock = self._sock
        # shutdown before close: closing an fd does not wake a thread
        # blocked in recv() on it
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        self._acker.join(timeout=5)


def stripe_of(name: bytes, n_stripes: int) -> int:
    """The stable stripe routing function: crc32 of the window name
    modulo the active stripe count.  Deterministic across processes and
    runs (no Python hash randomization), so the sharded path's
    per-coordinate ``name:r:ci`` windows spread over stripes the same
    way on every rank."""
    return zlib.crc32(name) % max(1, int(n_stripes))


class StripedDepositStream:
    """N parallel :class:`DepositStream` connections to one peer, striped
    by window name: one TCP stream serialises every frame through one
    sender thread and one server-side applier, while N stripes give the
    peer N senders, N connections and N concurrent appliers.  Window
    names spread over the stripes by :func:`stripe_of`.

    Duck-types the :class:`DepositStream` surface (``deposit_async``,
    ``flush``, ``close``, ``ack_ewma``, ``phase_ewma``, ``health``,
    ``reconnects``, ``set_codec``, ``shm_deposits``), so it drops into
    ``PipelinedRemoteWindow(stream=...)`` unchanged.  Routing is sticky
    per window name, so one window's deposits never reorder; :meth:`flush`
    fences every stripe.  Per-stripe ack-latency EWMAs roll up as the
    max over live stripes: a peer is as slow as its slowest stripe.  Not
    thread-safe for concurrent producers (the contract of one stream).

    The stripe count and the per-stripe coalescing cap are the transport
    autotuner's knobs: :meth:`apply_plan` actuates a
    :class:`~bluefog_tpu_torch.control.transport.TransportPlan` at a round
    boundary.  Growing opens fresh stripes; shrinking fences the closing
    stripes first, so no deposit strands."""

    def __init__(self, address: Tuple[str, int],
                 timeout_s: float = 30.0, *, n_stripes: int = 2,
                 max_stripes: int = 16, **stream_kwargs):
        if "on_ewma" in stream_kwargs:
            raise ValueError("on_ewma is owned by the striping rollup")
        self._addr = (address[0], int(address[1]))
        self._peer = f"{address[0]}:{address[1]}"
        self._timeout_s = float(timeout_s)
        self._kw = dict(stream_kwargs)
        self._max_stripes = max(1, int(max_stripes))
        self._plan_version = 0
        self._closed_wire_bytes = 0  # carried by stripes a plan closed
        # written by each stripe's ack thread, read anywhere: per-slot
        # float stores and a max over a snapshot, atomic under the GIL
        self._ewmas: List[Optional[float]] = []
        self._ack_ewma: Optional[float] = None
        self._stripes: List[DepositStream] = []
        try:
            for _ in range(max(1, min(int(n_stripes), self._max_stripes))):
                self._open_stripe()
        except BaseException:
            self.close()
            raise

    def _open_stripe(self) -> None:
        i = len(self._stripes)
        self._ewmas.append(None)
        self._stripes.append(DepositStream(
            self._addr, self._timeout_s,
            on_ewma=(lambda e, i=i: self._roll_up(i, e)), **self._kw))

    def _roll_up(self, i: int, ewma: float) -> None:
        # max of stripes: an optimistic mean would hide exactly the
        # stripe a slow-peer detector needs to see
        self._ewmas[i] = ewma
        vals = [v for v in self._ewmas[:len(self._stripes)]
                if v is not None]
        if vals:
            self._ack_ewma = max(vals)

    @property
    def n_stripes(self) -> int:
        """Live stripe connections."""
        return len(self._stripes)

    def apply_plan(self, plan) -> None:
        """Actuate a :class:`~bluefog_tpu_torch.control.transport.
        TransportPlan` at a round boundary: resize the stripe pool and
        retune every stripe's coalescing cap.  Shrinking fences the
        closing stripes before closing them, so actuation never strands a
        deposit and the exact mass audit holds through every retune.
        Routing is by window name modulo the stripe count, so a window's
        deposits may move to another stripe at a resize; growing does not
        fence, so two rounds' deposits into one window can then apply out
        of order (accumulates commute, and the audit's mass is exact)."""
        want = max(1, min(int(plan.stripes), self._max_stripes))
        while len(self._stripes) < want:
            self._open_stripe()
        if want < len(self._stripes):
            for s in self._stripes[want:]:
                s.flush()
            for i in range(len(self._stripes) - 1, want - 1, -1):
                self._closed_wire_bytes += self._stripes[i].wire_bytes
                self._stripes[i].close()
                self._ewmas[i] = None
            del self._stripes[want:]
        for s in self._stripes:
            s.set_max_batch_bytes(plan.coalesce_bytes)
        self._plan_version = int(plan.version)

    @property
    def plan_version(self) -> int:
        """Version of the TransportPlan last actuated (0 = launch)."""
        return self._plan_version

    # ------------------------------------------- DepositStream surface
    def deposit_async(self, name: bytes, slot: int, arr: np.ndarray, *,
                      accumulate: bool = True, copy: bool = True,
                      drain: bool = False) -> None:
        self._stripes[stripe_of(name, len(self._stripes))].deposit_async(
            name, slot, arr, accumulate=accumulate, copy=copy,
            drain=drain)

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Fence across all stripes: every earlier deposit on every
        stripe is applied when this returns."""
        for s in self._stripes:
            s.flush(timeout_s)

    def set_codec(self, codec: Optional[str]) -> None:
        for s in self._stripes:
            s.set_codec(codec)

    def set_max_batch_bytes(self, n: int) -> None:
        for s in self._stripes:
            s.set_max_batch_bytes(n)

    def ack_ewma(self) -> Optional[float]:
        """Max-of-stripes ack-latency EWMA."""
        return self._ack_ewma

    def phase_ewma(self) -> Optional[Dict[str, float]]:
        """Elementwise max over the stripes' {net, queue, apply} EWMAs:
        the phase split of the peer's worst case."""
        out: Optional[Dict[str, float]] = None
        for s in self._stripes:
            p = s.phase_ewma()
            if p is None:
                continue
            if out is None:
                out = dict(p)
            else:
                for k, v in p.items():
                    out[k] = max(out[k], v)
        return out

    @property
    def health(self):
        """Peer health of stripe 0 (all stripes share the peer; extra
        stripes carry payload, not liveness)."""
        return self._stripes[0].health if self._stripes else None

    @property
    def reconnects(self) -> int:
        """Sum of completed reconnect cycles across stripes."""
        return sum(s.reconnects for s in self._stripes)

    @property
    def shm_deposits(self) -> int:
        return sum(s.shm_deposits for s in self._stripes)

    @property
    def retired_batches(self) -> int:
        return sum(s.retired_batches for s in self._stripes)

    @property
    def replayed_batches(self) -> int:
        return sum(s.replayed_batches for s in self._stripes)

    @property
    def wire_bytes(self) -> int:
        return (self._closed_wire_bytes
                + sum(s.wire_bytes for s in self._stripes))

    @property
    def ack_latencies(self):
        """Stripe 0's recent ack latencies."""
        return self._stripes[0].ack_latencies

    def close(self) -> None:
        """Close every stripe.  Does not flush: fence first when
        exactness matters."""
        for i in range(len(self._stripes) - 1, -1, -1):
            self._stripes[i].close()
        self._stripes = []


class PipelinedRemoteWindow:
    """Per-window client handle over a per-peer :class:`DepositStream`:
    fire-and-forget :meth:`deposit_async` + :meth:`flush` fence, with
    synchronous ops (:meth:`read`, :meth:`read_self`, :meth:`deposit`)
    riding a separate request/response connection so they never interleave
    with the deposit stream's framing.

    ``stream=`` shares an existing peer stream across several windows of
    the SAME peer (a round's leaves then coalesce into one wire frame —
    the batched multi-deposit op; :func:`DepositStream.flush` on the
    shared stream fences all of them at once).  Without it the handle owns
    a private stream and :meth:`close` tears it down."""

    def __init__(self, address: Tuple[str, int], name: str,
                 timeout_s: float = 30.0, *, codec: Optional[str] = None,
                 topk_ratio: Optional[float] = None,
                 max_in_flight: Optional[int] = None,
                 max_queue_items: Optional[int] = None,
                 max_batch_bytes: Optional[int] = None,
                 reconnect=None,
                 heartbeat_interval_s: Optional[float] = None,
                 suspect_after_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None,
                 shm: Optional[bool] = None,
                 stream: Optional[DepositStream] = None,
                 sync_retry=None):
        """``sync_retry`` configures the SYNC connection's bounded
        retry for idempotent reads (see :class:`RemoteWindow`); it is
        independent of ``stream=`` because every handle owns its sync
        connection even when the deposit stream is shared.  ``shm=True``
        opts the owned stream into the same-host shared-memory fast
        path (see :class:`DepositStream`)."""
        self.name = name
        self._name_b = name.encode()
        if stream is not None and any(
                v is not None for v in (codec, topk_ratio, max_in_flight,
                                        max_queue_items, max_batch_bytes,
                                        reconnect,
                                        heartbeat_interval_s,
                                        suspect_after_s, dead_after_s,
                                        shm)):
            # a shared stream carries ITS configuration; accepting these
            # kwargs here would silently ignore them (e.g. codec='f32'
            # riding an uncompressed stream)
            raise ValueError(
                "stream= is mutually exclusive with codec/topk_ratio/"
                "max_in_flight/max_queue_items/max_batch_bytes/reconnect/"
                "heartbeat_interval_s/suspect_after_s/dead_after_s/shm — "
                "configure the shared DepositStream itself")
        self._sync = RemoteWindow(address, name, timeout_s,
                                  retry=sync_retry)
        self._owns_stream = stream is None
        if stream is not None:
            self.stream = stream
            return
        try:
            self.stream = DepositStream(
                address, timeout_s, codec=codec,
                topk_ratio=0.1 if topk_ratio is None else topk_ratio,
                max_in_flight=4 if max_in_flight is None else max_in_flight,
                max_queue_items=(1024 if max_queue_items is None
                                 else max_queue_items),
                max_batch_bytes=(16 << 20 if max_batch_bytes is None
                                 else max_batch_bytes),
                reconnect=reconnect,
                heartbeat_interval_s=(0.0 if heartbeat_interval_s is None
                                      else heartbeat_interval_s),
                suspect_after_s=(2.0 if suspect_after_s is None
                                 else suspect_after_s),
                dead_after_s=(20.0 if dead_after_s is None
                              else dead_after_s),
                shm=bool(shm))
        except BaseException:
            # a rejected handshake (version/feature) must not leak the
            # already-open sync connection and its server handler thread
            self._sync.close()
            raise

    @property
    def health(self):
        """Per-peer :class:`~bluefog_tpu.runtime.resilience.PeerHealth`
        of the underlying stream (None when resilience is off)."""
        return self.stream.health

    @property
    def ack_latencies(self):
        return self.stream.ack_latencies

    def ack_ewma(self) -> Optional[float]:
        """The stream's per-peer ack-latency EWMA (seconds; None before
        the first ack) — see :meth:`DepositStream.ack_ewma`."""
        return self.stream.ack_ewma()

    def phase_ewma(self) -> Optional[Dict[str, float]]:
        """The stream's wire-phase EWMA (net / queue / apply; None until
        a timed ack), see :meth:`DepositStream.phase_ewma`."""
        return self.stream.phase_ewma()

    @property
    def reconnects(self) -> int:
        """Completed reconnect+replay cycles on the underlying stream."""
        return self.stream.reconnects

    def set_codec(self, codec: Optional[str]) -> None:
        """Retune the stream's wire codec at a round boundary (see
        :meth:`DepositStream.set_codec`)."""
        self.stream.set_codec(codec)

    def deposit_async(self, slot: int, arr: np.ndarray, *,
                      accumulate: bool = True, copy: bool = True,
                      drain: bool = False) -> None:
        """Fire-and-forget deposit (see :meth:`DepositStream.
        deposit_async`); fence with :meth:`flush`."""
        self.stream.deposit_async(self._name_b, slot, arr,
                                  accumulate=accumulate, copy=copy,
                                  drain=drain)

    def flush(self, timeout_s: Optional[float] = None) -> None:
        """Fence: every prior :meth:`deposit_async` is applied on the
        owner when this returns.  On a shared stream this fences the whole
        peer (all windows), which is what the dsgd audit needs."""
        self.stream.flush(timeout_s)

    def deposit(self, slot: int, arr: np.ndarray, *,
                accumulate: bool = True) -> int:
        """Synchronous deposit (own round-trip; callers needing ordering
        vs the async stream must flush first)."""
        return self._sync.deposit(slot, arr, accumulate=accumulate)

    def read(self, slot: int, n_elems: int, dtype=np.float64, *,
             consume: bool = True) -> Tuple[np.ndarray, int]:
        return self._sync.read(slot, n_elems, dtype, consume=consume)

    def read_self(self, n_elems: int, dtype=np.float64) -> np.ndarray:
        return self._sync.read_self(n_elems, dtype)

    def close(self) -> None:
        """Close the handle (and its stream, when privately owned).  Does
        NOT flush — fence first when exactness matters."""
        if self._owns_stream:
            self.stream.close()
        self._sync.close()

