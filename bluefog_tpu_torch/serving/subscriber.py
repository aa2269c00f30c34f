"""Resumable push subscriptions: "push me every Nth round's weights".

Counterpart of ``bluefog_tpu/serving/subscriber.py``.  :class:`Subscriber`
is the streaming reader of the serving tier: it holds one SUBSCRIBE
connection to a trainer's
:class:`~bluefog_tpu_torch.runtime.window_server.WindowServer` and
receives round-stamped snapshots as the model trains.

- **Resumable.**  The subscriber owns a stable 64-bit lineage id and a
  per-connection epoch (the deposit streams' STREAM_ATTACH pattern, on
  the read path).  Its cursor, the highest round it fully received, is
  the delivery truth: on reconnect it re-subscribes with ``(sub_id,
  epoch+1, cursor)``, the server quiesces any sender of the old epoch and
  resumes strictly above the cursor.  A frame torn mid-push never
  advances the cursor, so its round is re-delivered; rounds at or below
  the cursor are never pushed again.  Across any number of disconnects,
  delivered rounds are strictly increasing.
- **Bounded reconnect.**  Outages are retried under a
  :class:`~bluefog_tpu_torch.runtime.resilience.Backoff` with a budget;
  exhaustion latches the error and the subscriber reports dead instead
  of dialing a gone trainer forever.
- **Silence detection.**  The server keepalives an idle subscription
  (about 1 s cadence); ``idle_timeout_s`` of total silence means a
  wedged or partitioned server and triggers the same bounded reconnect.
- **Slow consumers skip, never block.**  Delivery is into a bounded deque
  that drops the oldest pending snapshot; a slow ``on_snapshot`` callback
  delays only this subscriber.
- **Deltas.**  ``delta=True`` asks for op-10 delta pushes
  (:mod:`bluefog_tpu_torch.runtime.delta`), decoded through a
  per-connection :class:`~bluefog_tpu_torch.runtime.delta.DeltaApplier`.

The subscriber never writes after the SUBSCRIBE request: the connection
is one-way server push.
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time
from typing import Callable, Optional, Tuple

from bluefog_tpu_torch.runtime import resilience, wire_status
from bluefog_tpu_torch.runtime.delta import DeltaApplier, DeltaDesync
from bluefog_tpu_torch.serving.client import Snapshot
from bluefog_tpu_torch.tracing import recorder as _tr

__all__ = ["Subscriber"]


def _wire():
    from bluefog_tpu_torch.runtime import window_server as ws

    return ws


class Subscriber:
    """Background push-subscription reader (see module docstring).

    Args:
      address: the trainer's ``WindowServer`` address.
      group: snapshot group to follow (the dsgd loops publish
        ``f"{name}:{rank}"``).
      every: deliver at most every Nth round (the server skips the rest;
        ``skipped_rounds`` counts slow-reader skips beyond that stride).
      cursor: resume point, the highest round already consumed in a
        previous life (-1 = fresh).
      on_snapshot: optional callback invoked on this subscriber's thread
        for every delivered :class:`Snapshot`; with or without it,
        snapshots are also queued for :meth:`get`.
      reconnect: ``True`` (default) / dict of Backoff kwargs / ``False``
        (the first outage is terminal).
      idle_timeout_s: silence (no push, no keepalive) treated as a dead
        connection.
      queue_max: bounded delivery queue; overflow drops the oldest.
      delta: ask for op-10 delta pushes (a server that does not grant the
        feature sends full frames).
    """

    def __init__(self, address: Tuple[str, int], group: str, *,
                 every: int = 1, cursor: int = -1,
                 on_snapshot: Optional[Callable[[Snapshot], None]] = None,
                 reconnect=True, idle_timeout_s: float = 5.0,
                 timeout_s: float = 10.0, queue_max: int = 16,
                 delta: bool = False):
        self.group = group
        self._group_b = group.encode()
        self._addr = (address[0], int(address[1]))
        self._every = max(1, int(every))
        self.cursor = int(cursor)
        self._on_snapshot = on_snapshot
        self._reconnect_cfg = (dict(reconnect)
                               if isinstance(reconnect, dict)
                               else ({} if reconnect else None))
        self._idle_timeout_s = float(idle_timeout_s)
        self._timeout_s = float(timeout_s)
        self.sub_id = int.from_bytes(os.urandom(8), "little") or 1
        self._epoch = 0
        # the applier (receiver-side reconstruction) is per connection: a
        # reconnect resyncs on the first full-frame anchor, and a torn or
        # desynced delta never advances the cursor
        self._want_delta = bool(delta)
        self._delta_on = False
        # FEATURE_TRACE granted on the current connection: every push
        # frame carries a trace header after _PUSH (empty on keepalives),
        # and the consume span parents to the server's push span
        self._trace_on = False
        self._applier: Optional[DeltaApplier] = None
        self._sock: Optional[socket.socket] = None
        self.delta_frames = 0
        self.delivered = 0
        self.skipped_rounds = 0
        self.resumes = 0
        self._err: Optional[str] = None
        self._closed = threading.Event()
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque(
            maxlen=max(1, int(queue_max)))
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"bf-subscriber:{group}")
        self._thread.start()

    # ----------------------------------------------------------- consumer
    @property
    def error(self) -> Optional[str]:
        return self._err

    def get(self, timeout_s: Optional[float] = None) -> Optional[Snapshot]:
        """Pop the oldest queued snapshot (None on timeout).  Raises the
        latched error once the subscription is dead and drained."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._cv:
            while True:
                if self._q:
                    return self._q.popleft()
                if self._err is not None:
                    raise RuntimeError(
                        f"subscription to {self.group!r} failed: "
                        f"{self._err}")
                if self._closed.is_set():
                    return None
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    return None
                self._cv.wait(timeout=wait)

    def _kick(self) -> None:
        sock = self._sock
        if sock is not None:
            for fn in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    fn()
                except OSError:
                    pass

    def reparent(self, address: Tuple[str, int]) -> None:
        """Point this subscription at a new upstream (a relay child moving
        to a sibling or back to the root when its parent dies).  The
        lineage (``sub_id``, cursor) is preserved, so delivered rounds
        stay strictly increasing across the hand-off: the new upstream
        resumes strictly above the cursor, like any reconnect."""
        self._addr = (address[0], int(address[1]))
        # kick the pump off the old connection; the reconnect loop dials
        # the new address with (epoch+1, cursor)
        self._kick()

    def close(self) -> None:
        self._closed.set()
        with self._cv:
            self._cv.notify_all()
        self._kick()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------ plumbing
    def _fail(self, msg: str) -> None:
        with self._cv:
            if self._err is None:
                self._err = msg
            self._cv.notify_all()

    def _subscribe_once(self) -> socket.socket:
        """One connect + HELLO + SUBSCRIBE; raises on any failure."""
        ws = _wire()
        sock = socket.create_connection(self._addr, timeout=self._timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            want = ws.FEATURE_SUBSCRIBE
            trace_want = _tr.get() is not None
            if trace_want:
                want |= ws.FEATURE_TRACE
            if self._want_delta:
                want |= ws.FEATURE_DELTA
            ws._sendmsg_all(sock, [
                ws._HDR.pack(ws._MAGIC, ws._OP_HELLO, 0),
                ws._HELLO.pack(ws.PROTOCOL_VERSION, want)])
            (granted,) = ws._STATUS.unpack(
                ws._recv_exact(sock, ws._STATUS.size))
            if granted < 0 or not granted & ws.FEATURE_SUBSCRIBE:
                raise RuntimeError(
                    f"window server at {self._addr[0]}:{self._addr[1]} "
                    f"does not serve subscriptions (HELLO reply "
                    f"{int(granted)})")
            self._trace_on = bool(trace_want
                                  and granted & ws.FEATURE_TRACE)
            self._delta_on = bool(self._want_delta
                                  and granted & ws.FEATURE_DELTA)
            # a fresh connection gets a fresh reconstruction: its first
            # data frame is a full anchor (the server's encoder is per
            # connection too)
            self._applier = (DeltaApplier(self.group)
                             if self._delta_on else None)
            self._epoch += 1
            ws._sendmsg_all(sock, [
                ws._HDR.pack(ws._MAGIC, ws._OP_SUBSCRIBE,
                             len(self._group_b)), self._group_b,
                ws._SUB_REQ.pack(self.sub_id, self._epoch, self._every,
                                 self.cursor)])
            (rc,) = ws._STATUS.unpack(ws._recv_exact(sock, ws._STATUS.size))
            if rc < 0:
                if wire_status.is_retriable(int(rc)):
                    # ERR_BUSY from a relay at its fan-out limit: back off
                    # and retry (or re-parent), never a terminal refusal
                    raise ConnectionError(
                        f"subscribe to {self.group!r} deferred "
                        f"({int(rc)}): " + wire_status.err_text(int(rc)))
                raise RuntimeError(
                    f"subscribe to {self.group!r} rejected ({int(rc)}): "
                    + wire_status.err_text(int(rc)))
            # the idle timeout is the silence detector: the server
            # keepalives about once a second
            sock.settimeout(self._idle_timeout_s)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return sock

    def _deliver(self, snap: Snapshot, skipped: int) -> None:
        self.delivered += 1
        self.skipped_rounds += int(skipped)
        with self._cv:
            self._q.append(snap)  # bounded: overflow drops the oldest
            self._cv.notify_all()
        if self._on_snapshot is not None:
            try:
                self._on_snapshot(snap)
            except Exception as e:  # noqa: BLE001 (a consumer bug must
                # surface as this subscription's error, not kill the
                # thread silently)
                self._fail(f"on_snapshot callback raised: "
                           f"{type(e).__name__}: {e}")

    def _read_frames(self, sock: socket.socket) -> None:
        """Pump push frames until the connection dies; the cursor only
        advances after a full frame arrived (and, for op-10 deltas,
        decoded against the matching base)."""
        ws = _wire()
        while not self._closed.is_set():
            rnd, skipped, count = ws._PUSH.unpack(
                ws._recv_exact(sock, ws._PUSH.size))
            tctx = None
            if self._trace_on:
                # trace connections carry the server's push-span context
                # after every _PUSH header (zeros on keepalives and
                # untraced pushes): a deterministic parse
                t_id, s_id, _t_rnd = ws._TRACE_HDR.unpack(
                    ws._recv_exact(sock, ws._TRACE_HDR.size))
                if s_id:
                    tctx = (t_id, s_id)
            kind, base_rnd = 0, -1
            if self._delta_on:
                # delta connections carry the frame-kind header on every
                # frame, keepalives included, after the trace header
                kind, base_rnd = ws._DELTA_HDR.unpack(
                    ws._recv_exact(sock, ws._DELTA_HDR.size))
            t_con_w = time.time()
            t_con_p = time.perf_counter()
            if kind == ws._OP_DELTA:
                items = ws._recv_delta_leaves(sock, count)
                leaves = None
            else:
                leaves = ws._recv_leaves(sock, count)
            if tctx is not None:
                trec = _tr.get()
                if trec is not None:
                    # the delivered snapshot links causally back to the
                    # serving host's push span
                    trec.emit("consume", "tcp", t0=t_con_w,
                              dur=time.perf_counter() - t_con_p,
                              parent=tctx[1], round_=max(0, rnd),
                              trace_id=tctx[0], group=self.group)
            if rnd < 0:
                continue  # keepalive
            if rnd <= self.cursor:
                # the server must never re-push a consumed round; one that
                # does is not delivered twice
                continue
            if kind == ws._OP_DELTA:
                try:
                    # the whole frame is in hand: the apply yields the
                    # full reconstruction or refuses, and a refused delta
                    # never advances the cursor (the resumed stream
                    # re-promises the round on its anchor)
                    leaves = self._applier.apply(rnd, base_rnd, items)
                except DeltaDesync as e:
                    raise ConnectionError(str(e)) from e
                self.delta_frames += 1
            elif self._applier is not None:
                self._applier.anchor(rnd, leaves)
            self.cursor = rnd
            self._deliver(Snapshot(self.group, rnd, leaves,
                                   skipped=int(skipped), trace=tctx),
                          skipped)

    def _loop(self) -> None:
        bo: Optional[resilience.Backoff] = None
        while not self._closed.is_set():
            try:
                sock = self._subscribe_once()
            except RuntimeError as e:
                self._fail(str(e))  # a rejection: retrying cannot fix it
                return
            except (TimeoutError, ConnectionError, OSError) as e:
                if not self._sleep_backoff(bo := (bo or self._new_bo()),
                                           str(e)):
                    return
                continue
            self._sock = sock
            if self._closed.is_set():
                sock.close()
                return
            if self._epoch > 1:
                self.resumes += 1
            bo = None  # a live subscription resets the outage budget
            try:
                self._read_frames(sock)
            except (TimeoutError, ConnectionError, OSError, ValueError):
                pass
            finally:
                try:
                    sock.close()
                except OSError:
                    pass
            if self._closed.is_set():
                return
            if not self._sleep_backoff(bo := (bo or self._new_bo()),
                                       "push connection lost"):
                return

    def _new_bo(self) -> resilience.Backoff:
        return resilience.read_backoff(self._reconnect_cfg)

    def _sleep_backoff(self, bo: resilience.Backoff, why: str) -> bool:
        """One bounded backoff step; False when the subscription is done
        (closed, reconnect off, or budget exhausted: latched)."""
        if self._closed.is_set():
            return False
        if self._reconnect_cfg is None:
            self._fail(f"subscription connection lost ({why}); "
                       "reconnect disabled")
            return False
        try:
            delay = bo.next_delay()
        except resilience.BudgetExhausted:
            self._fail(f"reconnect budget exhausted after {bo.attempts} "
                       f"attempt(s) ({why}): trainer unreachable")
            return False
        return not self._closed.wait(delay)
