"""Elastic-membership records: the barrier directory as the roster.

The port's copy of ``bluefog_tpu/runtime/membership.py``.  The resilience
layer disseminates unplanned membership change through the shared
barrier directory (``dead.<r>`` tombstones, the one medium every rank
polls anyway).  This module is the vocabulary for intentional change on
the same channel:

- ``member.<r>``  — a JOIN announcement: rank ``r`` has attached its
  window server to the running job, warm-started from a neighbor's
  window, and asks to be admitted at the next round boundary.  The file
  content is a generation token: a rank can join, leave and rejoin, and
  every admission rendezvous is named by its token so stage files from a
  previous life can never satisfy a new rendezvous.
- ``leaving.<r>`` — a graceful-drain intent: rank ``r`` wants out and
  asks the live members to fence their deposit streams to it and meet at
  the leave rendezvous, after which nothing is in flight toward it and
  it can hand its push-sum mass to its out-neighbors exactly.
- ``left.<r>``    — drain complete: the final flagged deposits were
  acknowledged as applied; the mass is conserved among the remaining
  members (a corpse's, via ``dead.<r>``, is written off).

Records are written atomically (tmp + rename, like the ``winaddr``
files) so a reader never sees a torn token, and a joiner clears its own
stale ``dead``/``left`` records from a previous life before announcing.
The protocol that consumes them lives in
:func:`bluefog_tpu_torch.runtime.async_windows.run_async_dsgd_rank`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Set

__all__ = [
    "MembershipView",
    "clear_record",
    "new_token",
    "read_record",
    "scan",
    "write_record",
]

_KINDS = ("member", "leaving", "left", "dead")


def new_token() -> str:
    """A per-announcement generation token: unique across a rank's
    lives (pid + random), filesystem-safe, torn-read-proof via the
    atomic record write."""
    return f"{os.getpid()}-{os.urandom(4).hex()}"


def _path(dirpath: str, kind: str, rank: int) -> str:
    if kind not in _KINDS:
        raise ValueError(f"unknown membership record kind {kind!r}")
    return os.path.join(dirpath, f"{kind}.{int(rank)}")


def write_record(dirpath: str, kind: str, rank: int,
                 token: str = "") -> None:
    """Atomically publish ``<kind>.<rank>`` with ``token`` as content."""
    path = _path(dirpath, kind, rank)
    with open(path + ".tmp", "w") as f:
        f.write(token)
    os.replace(path + ".tmp", path)


def read_record(dirpath: str, kind: str, rank: int) -> Optional[str]:
    """The record's token, or None when absent."""
    try:
        with open(_path(dirpath, kind, rank)) as f:
            return f.read().strip()
    except OSError:
        return None


def clear_record(dirpath: str, kind: str, rank: int) -> bool:
    """Remove a record (a rejoiner clearing its previous life); True if
    one existed."""
    try:
        os.unlink(_path(dirpath, kind, rank))
        return True
    except OSError:
        return False


@dataclasses.dataclass
class MembershipView:
    """One scan of the roster directory.

    ``announced``/``leaving``/``left`` map rank -> generation token;
    ``dead`` is the tombstone set (no token — a corpse announces
    nothing).  ``addressed`` is the set of ranks that ever published a
    window address (``winaddr.<r>``) — the joiner's member-discovery
    universe."""

    announced: Dict[int, str]
    leaving: Dict[int, str]
    left: Dict[int, str]
    dead: Set[int]
    addressed: Set[int]

    def current_members(self) -> Set[int]:
        """Best-effort live set from records alone: every rank that
        published an address, minus tombstones and completed leavers.
        A rejoiner's fresh ``member`` record overrides its old
        ``left``/``dead`` state (it cleared those before announcing)."""
        return self.addressed - self.dead - set(self.left)


def scan(dirpath: str, n_ranks: int) -> MembershipView:
    announced: Dict[int, str] = {}
    leaving: Dict[int, str] = {}
    left: Dict[int, str] = {}
    dead: Set[int] = set()
    addressed: Set[int] = set()
    for r in range(n_ranks):
        tok = read_record(dirpath, "member", r)
        if tok is not None:
            announced[r] = tok
        tok = read_record(dirpath, "leaving", r)
        if tok is not None:
            leaving[r] = tok
        tok = read_record(dirpath, "left", r)
        if tok is not None:
            left[r] = tok
        if os.path.exists(os.path.join(dirpath, f"dead.{r}")):
            dead.add(r)
        if os.path.exists(os.path.join(dirpath, f"winaddr.{r}")):
            addressed.add(r)
    return MembershipView(announced=announced, leaving=leaving, left=left,
                          dead=dead, addressed=addressed)
