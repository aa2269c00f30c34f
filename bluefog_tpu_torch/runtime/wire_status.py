"""The ONE registry of wire v2 status codes.

The port's copy of ``bluefog_tpu/runtime/wire_status.py``: the same
codes, texts and retriable set, so a port peer and a JAX-package peer
read each other's statuses alike.  The server
(:mod:`bluefog_tpu_torch.runtime.window_server`) and its clients import
from here; never re-type a code.  Dependency-free (stdlib only).

Conventions: codes are negative ``i64`` statuses on the wire.  ``-1``
(native-table op failure) and the geometry/window codes predate wire v2
and are shared with the in-process table; ``-100`` and below are
wire-protocol codes proper.
"""

from __future__ import annotations

from typing import Dict

__all__ = [
    "ERR_BAD_OP",
    "ERR_BUSY",
    "ERR_CODEC",
    "ERR_DELTA_BASE",
    "ERR_GEOMETRY",
    "ERR_NO_SNAPSHOT",
    "ERR_NO_WINDOW",
    "ERR_RELAY_LOOP",
    "ERR_ROUND_ROLLED",
    "ERR_STALE_EPOCH",
    "ERR_TOO_LARGE",
    "ERR_VERSION",
    "PROTOCOL_VERSION",
    "STATUS_TEXT",
    "WIRE_V2_CODES",
    "err_text",
    "is_retriable",
]

PROTOCOL_VERSION = 2

# table-level statuses (shared with the native/fallback window table)
ERR_GEOMETRY = -2     # dtype/n_elems disagree with the window's geometry
ERR_NO_WINDOW = -3    # no such window on the serving host

# wire-protocol statuses (v2)
ERR_BAD_OP = -100        # unparseable request
ERR_VERSION = -101       # protocol version mismatch (v1 frame/bad HELLO)
ERR_CODEC = -102         # codec not granted / payload undecodable
# -103 is deliberately unassigned (a v2 draft code that never shipped);
# keep the gap so an old peer emitting it is recognizably foreign
ERR_TOO_LARGE = -104     # claimed length exceeds any legal encoding
ERR_STALE_EPOCH = -105   # attach/batch/subscribe from a superseded epoch
ERR_BUSY = -106          # previous stream generation could not quiesce
ERR_ROUND_ROLLED = -107  # RETRIABLE: pinned snapshot round superseded
ERR_NO_SNAPSHOT = -108   # group/leaf has no published snapshot (yet)
ERR_DELTA_BASE = -109    # RETRIABLE: DELTA frame base round != the
                         # receiver's reconstruction cursor — drop the
                         # connection; the resumed stream resyncs with a
                         # full-frame anchor (wire op 10, docs/serving.md)
ERR_RELAY_LOOP = -110    # a relay refused a subscription that would
                         # close a cycle (its upstream IS its own serving
                         # address) — terminal: a relay tree must be a
                         # tree

STATUS_TEXT: Dict[int, str] = {
    ERR_GEOMETRY: "size/dtype mismatch with the window's geometry",
    ERR_NO_WINDOW: "no such window on the serving host",
    ERR_BAD_OP: "unparseable request",
    ERR_VERSION: (f"protocol version mismatch (this client speaks "
                  f"v{PROTOCOL_VERSION}; peer rejected the handshake)"),
    ERR_CODEC: "wire codec not negotiated or payload undecodable",
    ERR_TOO_LARGE: "claimed payload length exceeds any legal encoding",
    ERR_STALE_EPOCH: ("stream epoch superseded (a newer connection of "
                      "this DepositStream attached; this one is a "
                      "zombie)"),
    ERR_BUSY: ("previous stream generation still draining; attach "
               "again after backoff"),
    ERR_ROUND_ROLLED: ("snapshot round rolled: the pinned round is no "
                       "longer current (retriable — re-pin at the "
                       "table's new round and re-read)"),
    ERR_NO_SNAPSHOT: ("no round-stamped snapshot published for this "
                      "group/leaf (retriable while the publisher warms "
                      "up; terminal for a misspelled name)"),
    ERR_DELTA_BASE: ("delta base round does not match the receiver's "
                     "reconstruction cursor (retriable: drop the push "
                     "connection and resubscribe — the resumed stream "
                     "resyncs with a full-frame anchor)"),
    ERR_RELAY_LOOP: ("relay subscription refused: the upstream address "
                     "is the relay's own serving address, which would "
                     "close a cycle — point the relay at its parent "
                     "tier, not itself"),
}

# the v2 wire-protocol codes proper
WIRE_V2_CODES = (ERR_BAD_OP, ERR_VERSION, ERR_CODEC, ERR_TOO_LARGE,
                 ERR_STALE_EPOCH, ERR_BUSY, ERR_ROUND_ROLLED,
                 ERR_NO_SNAPSHOT, ERR_DELTA_BASE, ERR_RELAY_LOOP)

# the explicitly unassigned gaps of the contiguous v2 range, derived from
# the registry so adding a code can never leave this tuple stale
UNASSIGNED_CODES = tuple(
    c for c in range(max(WIRE_V2_CODES), min(WIRE_V2_CODES) - 1, -1)
    if c not in WIRE_V2_CODES)

# codes a client may retry without changing anything (vs. terminal
# protocol rejections, where retrying only relabels the real error)
_RETRIABLE = frozenset({ERR_BUSY, ERR_ROUND_ROLLED, ERR_NO_SNAPSHOT,
                        ERR_DELTA_BASE})


def is_retriable(rc: int) -> bool:
    """True for statuses a well-behaved client retries (after backoff /
    re-pin); False for terminal rejections."""
    return rc in _RETRIABLE


def err_text(rc: int) -> str:
    """Human-readable explanation of a negative wire status."""
    return STATUS_TEXT.get(rc, "window missing, slot out of range, or "
                           "size/dtype mismatch")
