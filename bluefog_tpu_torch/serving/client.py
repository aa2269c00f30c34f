"""Pull one round-consistent snapshot over the wire: the SNAPSHOT op.

Counterpart of ``bluefog_tpu/serving/client.py``.  :class:`SnapshotClient`
is the read-path twin of
:class:`~bluefog_tpu_torch.runtime.window_server.RemoteWindow`:

- every operation runs under a deadline (a wedged trainer surfaces as a
  timeout, never a hung reader thread);
- transport failures (refused connects, replies torn mid-frame by a
  dying server, timeouts) are retried on a fresh connection under a
  bounded :class:`~bluefog_tpu_torch.runtime.resilience.Backoff`
  (snapshot reads are pure, so re-issuing is always safe);
- a successful read returns a :class:`Snapshot` whose ``round`` stamps
  every leaf (the server copies them under the table's swap lock), a
  pinned read that lost its race raises :class:`~bluefog_tpu_torch.
  serving.snapshots.RoundRolled` (retriable), and "nothing published
  yet" is :class:`~bluefog_tpu_torch.serving.snapshots.
  SnapshotUnavailable`.

Consumers check the round stamp (or pass ``min_round=``) before acting on
a snapshot.
"""

from __future__ import annotations

import socket
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from bluefog_tpu_torch.runtime import resilience, wire_status
from bluefog_tpu_torch.serving.snapshots import (RoundRolled,
                                                 SnapshotUnavailable)
from bluefog_tpu_torch.tracing import recorder as _tr

__all__ = ["Snapshot", "SnapshotClient"]


@dataclass
class Snapshot:
    """One round-consistent snapshot: every leaf is from ``round``.

    ``skipped`` is the count of due rounds the sender skipped before this
    delivery (the skip-to-latest backlog, which a relay reports as the
    staleness its tier added); ``trace`` is the upstream push span's
    ``(trace_id, span_id)`` on FEATURE_TRACE subscriptions, so a
    re-publisher can parent its hop into the trainer's trace."""

    group: str
    round: int
    leaves: Dict[str, np.ndarray] = field(default_factory=dict)
    skipped: int = 0
    trace: Optional[Tuple[int, int]] = None

    def __getitem__(self, name: str) -> np.ndarray:
        return self.leaves[name]

    def __contains__(self, name: str) -> bool:
        return name in self.leaves


def _wire():
    """The wire constants live with the server; imported lazily so the
    publish-only path never loads the client machinery."""
    from bluefog_tpu_torch.runtime import window_server as ws

    return ws


class SnapshotClient:
    """Synchronous round-consistent snapshot reader (one per thread).

    ``retry`` bounds the transport-retry loop: ``True`` (default) uses the
    standard backoff, a dict overrides
    :class:`~bluefog_tpu_torch.runtime.resilience.Backoff` kwargs,
    ``False`` fails on the first transport error.  :class:`RoundRolled`
    from a pinned read and :class:`SnapshotUnavailable` after the wait
    budget are the caller's protocol, never swallowed here."""

    def __init__(self, address: Tuple[str, int], group: str, *,
                 timeout_s: float = 10.0, retry=True):
        self.group = group
        self._group_b = group.encode()
        self._addr = (address[0], int(address[1]))
        self._timeout_s = float(timeout_s)
        self._retry_cfg = (dict(retry) if isinstance(retry, dict)
                           else ({} if retry else None))
        self._sock: Optional[socket.socket] = None
        # FEATURE_TRACE granted on the current connection: SNAPSHOT
        # requests then carry the reader's trace context, so the serving
        # host's serve span parents into this reader's trace
        self._trace_on = False

    # ---------------------------------------------------------- transport
    def _backoff(self) -> resilience.Backoff:
        return resilience.read_backoff(self._retry_cfg)

    def _connect(self) -> socket.socket:
        ws = _wire()
        sock = socket.create_connection(self._addr,
                                        timeout=self._timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self._timeout_s)
            want = ws.FEATURE_SNAPSHOT
            trace_want = _tr.get() is not None
            if trace_want:
                want |= ws.FEATURE_TRACE
            ws._sendmsg_all(sock, [
                ws._HDR.pack(ws._MAGIC, ws._OP_HELLO, 0),
                ws._HELLO.pack(ws.PROTOCOL_VERSION, want)])
            (granted,) = ws._STATUS.unpack(
                ws._recv_exact(sock, ws._STATUS.size))
            if granted < 0 or not granted & ws.FEATURE_SNAPSHOT:
                raise RuntimeError(
                    f"window server at {self._addr[0]}:{self._addr[1]} "
                    "does not serve round-stamped snapshots "
                    f"(HELLO reply {int(granted)}): older wire version?")
            self._trace_on = bool(trace_want
                                  and granted & ws.FEATURE_TRACE)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return sock

    def _drop_conn(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _read_once(self, names: Optional[Sequence[str]],
                   pin_round: int) -> Snapshot:
        ws = _wire()
        if self._sock is None:
            self._sock = self._connect()
        sock = self._sock
        with _tr.span("snapshot_read", "tcp", group=self.group,
                      peer=f"{self._addr[0]}:{self._addr[1]}"):
            req = [ws._HDR.pack(ws._MAGIC, ws._OP_SNAPSHOT,
                                len(self._group_b)), self._group_b,
                   ws._SNAP_REQ.pack(pin_round, len(names or ()))]
            if self._trace_on:
                # the reader's causal context rides right after the frame
                # header: the server's snapshot_serve span parents to
                # this read span
                req.insert(1, ws._TRACE_HDR.pack(
                    *(_tr.wire_ctx() or (0, 0, 0))))
            for n in (names or ()):
                nb = n.encode()
                req.append(ws._LEAF_NAME.pack(len(nb)))
                req.append(nb)
            ws._sendmsg_all(sock, req)
            (rc,) = ws._STATUS.unpack(ws._recv_exact(sock, ws._STATUS.size))
            if rc == wire_status.ERR_ROUND_ROLLED:
                raise RoundRolled(self.group, pin_round, -1)
            if rc == wire_status.ERR_NO_SNAPSHOT:
                raise SnapshotUnavailable(
                    f"server has no snapshot for group {self.group!r} "
                    f"(leaves {list(names) if names else 'all'})")
            if rc < 0:
                raise RuntimeError(
                    f"snapshot read of {self.group!r} failed ({rc}): "
                    + wire_status.err_text(int(rc)))
            (count,) = ws._SNAP_CNT.unpack(
                ws._recv_exact(sock, ws._SNAP_CNT.size))
            return Snapshot(self.group, int(rc), ws._recv_leaves(sock, count))

    # -------------------------------------------------------------- reads
    def snapshot(self, names: Optional[Sequence[str]] = None, *,
                 pin_round: int = -1, min_round: int = -1,
                 wait_s: float = 0.0) -> Snapshot:
        """Read a round-consistent snapshot.

        ``pin_round >= 0`` demands exactly that round:
        :class:`RoundRolled` (retriable) if the table moved on.
        ``min_round`` rejects stale serves: rounds below it are retried
        within ``wait_s`` (also the wait for the first publish), then
        :class:`SnapshotUnavailable`.  Transport faults (torn replies,
        timeouts, reconnects) retry on fresh connections under the bounded
        backoff.  The returned :attr:`Snapshot.round` stamps every leaf."""
        deadline = time.monotonic() + max(0.0, wait_s)
        bo = self._backoff() if self._retry_cfg is not None else None
        last: Optional[BaseException] = None
        while True:
            try:
                snap = self._read_once(names, pin_round)
            except RoundRolled:
                raise  # the connection is fine; the pinned round raced
            except SnapshotUnavailable:
                if time.monotonic() < deadline:
                    time.sleep(0.02)
                    continue
                raise
            except (TimeoutError, ConnectionError, OSError,
                    RuntimeError) as e:
                # a reply torn mid-frame desyncs the connection: drop it
                # and retry a fresh one (reads are pure) under the budget
                self._drop_conn()
                if isinstance(e, RuntimeError) and not isinstance(
                        e, (SnapshotUnavailable, RoundRolled)):
                    raise  # a server-side rejection (bad op, feature)
                last = e
                if bo is None:
                    raise
                try:
                    time.sleep(bo.next_delay())
                except resilience.BudgetExhausted:
                    raise RuntimeError(
                        f"snapshot read of {self.group!r} exhausted its "
                        f"retry budget after {bo.attempts} attempt(s): "
                        f"{last}") from last
                continue
            if snap.round < min_round:
                if time.monotonic() < deadline:
                    time.sleep(0.02)
                    continue
                raise SnapshotUnavailable(
                    f"group {self.group!r} is stale: newest round "
                    f"{snap.round} < required min_round {min_round}")
            return snap

    def close(self) -> None:
        self._drop_conn()

    def __enter__(self) -> "SnapshotClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
