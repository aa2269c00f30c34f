"""The chaos spec grammar: one parser for every consumer.

Counterpart of ``bluefog_tpu/chaos/spec.py``.  This module is the one
definition of the ``BLUEFOG_TPU_CHAOS`` rule grammar: the live injector
(:mod:`bluefog_tpu_torch.chaos.injector`) executes the parsed
:class:`Rule` objects against real traffic (socket shims return actions,
process faults deliver real signals).  The grammar is the :data:`GRAMMAR`
text below, written down once (``python -m bluefog_tpu_torch.chaos
--grammar`` prints it), and validation lives here too, so every consumer
refuses the same malformed specs with the same :class:`ChaosSpecError`.
The variable name and the grammar are the JAX package's, so one spec
drives both runtimes in a mixed job.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = [
    "ChaosSpecError",
    "GRAMMAR",
    "Rule",
    "parse_spec",
    "SOCKET_FAULTS",
    "RANK_FAULTS",
    "SOCKET_SITES",
]

#: The spec grammar, defined and documented once (printed by
#: ``python -m bluefog_tpu_torch.chaos --grammar``).
GRAMMAR = """\
spec  := rule (';' rule)*
rule  := site ':' fault (':' key '=' value)*
site  := 'server' | 'ack' | 'client' | 'read' | 'sub' | 'relay' | 'any'
       | 'rank<N>'
fault := drop | truncate | delay | stall            (socket sites)
       | sigkill | sigstop | die | stall            (rank sites)
       | leave | join                               (membership churn)

socket keys: after_frames=N  every=K  prob=P  rate=P  times=T  seed=S
             ms=M (delay)    s=S (stall)
             (rate= is the lossy-link spelling of prob=: a link that
             loses ~P of its frames, deterministic per seed)
rank keys:   at_step=N  after_s=T  for_s=T (sigstop thaw / stall length)
             (leave needs at_step=; join needs after_s=)

sites 'server'/'ack'/'client' are the deposit (write) path; 'read' cuts
or stalls sync-read/SNAPSHOT replies on the serving host, 'sub' the
subscription push sender, 'relay' a relay node's re-publish of an
upstream snapshot (drop = the round is not re-published, children see
a skip; truncate additionally tears the relay's upstream link, forcing
a cursor-gap resync) — the read-path fault surface.  The fleet
simulator interprets the same rules against virtual
traffic: socket rules hit the simulated host's transport, rank rules
schedule kills/drains/stalls/joins on the virtual clock.
(In this package the read, sub and relay sites parse; the read site
fires at sync reads, and SNAPSHOT, the subscription sender and the
relay come with the serve-while-training read path.)

examples:
  server:drop:after_frames=40      cut a server connection at frame 40
  ack:drop:after_frames=3          apply batch 3, drop before the ack
  client:truncate:after_frames=5   send half a frame, then cut
  server:delay:ms=20:prob=0.1      delay 10% of frames by 20 ms
  server:drop:rate=0.05:seed=3     a 5%-loss lossy link (seeded)
  read:truncate:every=7            tear every 7th read reply mid-frame
  read:stall:s=2:prob=0.05         wedge 5% of read replies for 2 s
  sub:drop:after_frames=10         cut a push subscription at frame 10
  sub:stall:s=1:every=13           stall every 13th snapshot push 1 s
  relay:drop:every=9               a relay skips every 9th re-publish
  relay:truncate:after_frames=20   tear a relay's uplink at land 20
  rank2:sigkill:at_step=8          rank 2 SIGKILLs itself at step 8
  rank1:sigstop:after_s=0.8:for_s=1  freeze rank 1 for 1 s, then thaw
  rank1:leave:at_step=20           graceful drain (mass handed off)
  rank3:join:after_s=0.5           rank 3 attaches to the job at t=0.5s
"""

SOCKET_FAULTS = ("drop", "truncate", "delay", "stall")
RANK_FAULTS = ("sigkill", "sigstop", "die", "stall", "leave", "join")
# 'read' fires where the server is about to send a sync-read / SNAPSHOT
# reply (drop = vanish, truncate = reply torn mid-frame, stall = wedged
# owner); 'sub' fires in the per-subscription push sender (stall = slow
# push channel, drop/truncate = the reader's connection cut, torn for
# truncate); 'relay' fires in a relay node's land/re-publish path
# (drop = the round is not re-published, truncate = that plus a torn
# uplink — the cursor-gap resync case).  Together they are the
# READ-path fault surface, the twin of the PR-5 deposit-path sites.
SOCKET_SITES = ("server", "ack", "client", "read", "sub", "relay", "any")

_INT_KEYS = ("after_frames", "every", "times", "seed", "at_step")
_FLOAT_KEYS = ("prob", "rate", "ms", "s", "after_s", "for_s")


class ChaosSpecError(ValueError):
    """Malformed ``BLUEFOG_TPU_CHAOS`` spec."""


@dataclasses.dataclass
class Rule:
    site: str                 # 'server' | 'ack' | 'client' | 'any' | 'rank'
    fault: str
    rank: Optional[int] = None
    after_frames: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    # the LOSSY-LINK trigger: an independent seeded coin per frame, like
    # ``prob`` but named for what it models — a link that loses ~rate of
    # its frames, deterministically per seed.  One of prob/rate per rule.
    rate: Optional[float] = None
    times: Optional[int] = None      # None -> default per trigger kind
    seed: int = 0
    ms: float = 0.0                  # delay milliseconds
    s: float = 0.0                   # stall seconds
    at_step: Optional[int] = None
    after_s: Optional[float] = None
    for_s: Optional[float] = None

    def max_fires(self) -> int:
        """0 = unlimited."""
        if self.times is not None:
            return self.times
        # a one-shot by nature: counter threshold or a scheduled fault
        if (self.after_frames is not None or self.at_step is not None
                or self.after_s is not None):
            return 1
        return 0


def _parse_rule(text: str, index: int) -> Rule:
    parts = [p.strip() for p in text.split(":") if p.strip()]
    if len(parts) < 2:
        raise ChaosSpecError(
            f"rule {text!r}: need at least '<site>:<fault>'")
    site_raw, fault = parts[0].lower(), parts[1].lower()
    rank: Optional[int] = None
    if site_raw.startswith("rank"):
        try:
            rank = int(site_raw[4:])
        except ValueError:
            raise ChaosSpecError(
                f"rule {text!r}: bad rank site {site_raw!r} "
                "(want e.g. 'rank2')") from None
        site = "rank"
        if fault not in RANK_FAULTS:
            raise ChaosSpecError(
                f"rule {text!r}: fault {fault!r} is not a rank fault "
                f"{RANK_FAULTS}")
    elif site_raw in SOCKET_SITES:
        site = site_raw
        if fault not in SOCKET_FAULTS:
            raise ChaosSpecError(
                f"rule {text!r}: fault {fault!r} is not a socket fault "
                f"{SOCKET_FAULTS}")
    else:
        raise ChaosSpecError(
            f"rule {text!r}: unknown site {site_raw!r} (want one of "
            f"{SOCKET_SITES} or 'rank<N>')")
    kw: Dict[str, object] = {}
    for p in parts[2:]:
        if "=" not in p:
            raise ChaosSpecError(f"rule {text!r}: bad key=value {p!r}")
        k, v = p.split("=", 1)
        k = k.strip().lower()
        try:
            if k in _INT_KEYS:
                kw[k] = int(v)
            elif k in _FLOAT_KEYS:
                kw[k] = float(v)
            else:
                raise ChaosSpecError(
                    f"rule {text!r}: unknown key {k!r}")
        except ValueError:
            raise ChaosSpecError(
                f"rule {text!r}: bad value for {k!r}: {v!r}") from None
    rule = Rule(site=site, fault=fault, rank=rank,
                seed=int(kw.pop("seed", index)), **kw)  # type: ignore
    if rule.site == "rank" and rule.at_step is None and rule.after_s is None:
        raise ChaosSpecError(
            f"rule {text!r}: rank faults need at_step= or after_s=")
    if rule.fault == "die" and rule.at_step is None:
        raise ChaosSpecError(
            f"rule {text!r}: 'die' is a thread-loop fault and needs "
            "at_step= (a timer thread cannot kill another thread)")
    if rule.fault == "leave" and rule.at_step is None:
        raise ChaosSpecError(
            f"rule {text!r}: 'leave' is a graceful drain executed by the "
            "rank loop itself and needs at_step= (the leave protocol — "
            "fence, mass handoff, record — must run on the leaving "
            "rank's own thread at a round boundary)")
    if rule.fault == "join" and rule.after_s is None:
        raise ChaosSpecError(
            f"rule {text!r}: 'join' schedules when a rank ATTACHES to "
            "the running job and needs after_s= (queried by the elastic "
            "runner via join_times(), not executed as a fault)")
    if rule.prob is not None and rule.rate is not None:
        raise ChaosSpecError(
            f"rule {text!r}: prob= and rate= are the same trigger "
            "(a seeded per-frame coin); give one, not both")
    for k in ("prob", "rate"):
        v = getattr(rule, k)
        if v is not None and not (0.0 <= v <= 1.0):
            raise ChaosSpecError(f"rule {text!r}: {k} must be in [0, 1]")
    if rule.rate is not None and rule.site == "rank":
        raise ChaosSpecError(
            f"rule {text!r}: rate= is a socket-site trigger (a lossy "
            "link); rank faults are scheduled with at_step=/after_s=")
    return rule


def parse_spec(spec: str) -> List[Rule]:
    rules = [
        _parse_rule(part, i)
        for i, part in enumerate(p for p in spec.split(";") if p.strip())
    ]
    if not rules:
        raise ChaosSpecError(f"empty chaos spec {spec!r}")
    return rules
