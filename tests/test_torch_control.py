"""The port's communication control plane (``bluefog_tpu_torch/control``),
its ``MixingTracker`` and the runners' ``control=`` and transport tuning,
held against the JAX package's.

1. Every pure case of ``tests/test_control.py`` (``TestCommPlan``,
   ``TestControlConfig``, ``TestEvidence``, ``TestPlanConvergence``,
   ``TestNoFlap``, ``TestDecisionTable``, ``TestPhaseEvidence``,
   ``TestPenalizedReplan``) on the port; wherever a case decides a plan,
   the JAX package's ``decide_plan`` on the same evidence gives the same
   canonical bytes (``_decide``).  Over 30 seeded evidence multisets x 8
   ranks x 3 generations the port's plans are byte-identical to the
   reference's.  Records written by one package are read by the other.
2. ``TestTransportAutotune`` and the stripe resize that never strands a
   deposit (``tests/test_transport_fastpath.py``), the latter against a
   port server and a JAX-package server; ``TestTreePlan``'s pure cases
   (``tests/test_relay.py``); seeded transport and tree evidence decided
   byte-identically by both packages.
3. ``MixingTracker``: predicted, measured and excess values within 1e-12
   of the reference's on a ring, a healed ring and after a rebase.
4. Integration (``TestThreadIntegration``): the slow rank penalized with an
   exact audit, ``stop_after_steps``, a chaos-killed rank's evidence that
   stops voting, the validation errors over processes; 3 processes over
   tcp with control and ``ack:drop`` (byte-identical final plans, an exact
   audit, replay); the 4-process lossy link of
   ``tests/_mp_control_worker.py`` (slow, chaos).
"""

import dataclasses
import json
import math
import os
import random
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

import bluefog_tpu.control as RCtl
from bluefog_tpu.metrics.health import MixingTracker as RTracker
from bluefog_tpu_torch import chaos as PChaos
from bluefog_tpu_torch import topology as T
from bluefog_tpu_torch.control import (CODEC_LADDER, CommController,
                                       CommPlan, ControlConfig, Evidence,
                                       EvidenceBoard, canonicalize,
                                       decide_plan, plan_topology,
                                       read_evidence, write_evidence)
from bluefog_tpu_torch.metrics.health import MixingTracker
from bluefog_tpu_torch.runtime import async_windows as aw
from bluefog_tpu_torch.runtime import resilience as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _chaos_isolated():
    from bluefog_tpu import chaos as RChaos

    PChaos.reset()
    RChaos.reset()
    yield
    PChaos.reset()
    RChaos.reset()


def _name(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _ref_cfg(cfg):
    return RCtl.ControlConfig(**dataclasses.asdict(cfg))


def _ref_ev(ev):
    return RCtl.Evidence.from_json(ev.to_json())


def _decide(prev, round_, evs, cfg):
    """The port's ``decide_plan``, held byte for byte to the JAX
    package's on the same inputs."""
    evs = list(evs)
    got = decide_plan(prev, round_, evs, cfg)
    want = RCtl.decide_plan(RCtl.CommPlan.from_bytes(prev.to_bytes()),
                            round_, [_ref_ev(e) for e in evs], _ref_cfg(cfg))
    assert got.to_bytes() == want.to_bytes()
    return got


# ---------------------------------------------------------------------------
# 1. plan, config and evidence encodings
# ---------------------------------------------------------------------------


class TestCommPlan:
    def test_bytes_roundtrip(self):
        p = CommPlan(version=3, round=40, slow=(5, 1), densify=1,
                     gossip_every=2, codec_level=1)
        q = CommPlan.from_bytes(p.to_bytes())
        assert q == p and q.slow == (1, 5)
        assert p.to_bytes() == RCtl.CommPlan(
            version=3, round=40, slow=(5, 1), densify=1, gossip_every=2,
            codec_level=1).to_bytes()

    def test_canonical_bytes_are_key_sorted_json(self):
        d = json.loads(CommPlan(version=1, round=2).to_bytes())
        assert list(d) == sorted(d)

    def test_clamping(self):
        p = CommPlan(densify=99, gossip_every=0, codec_level=99)
        assert p.densify == 2 and p.gossip_every == 1
        assert p.codec_level == len(CODEC_LADDER) - 1
        assert CODEC_LADDER == RCtl.CODEC_LADDER

    def test_codec_property(self):
        assert CommPlan(codec_level=0).codec is None
        assert CommPlan(codec_level=1).codec == "f32"
        assert CommPlan(codec_level=2).codec == "topk"


class TestControlConfig:
    def test_defaults_are_the_reference_defaults(self):
        assert dataclasses.asdict(ControlConfig()) == dataclasses.asdict(
            RCtl.ControlConfig())

    @pytest.mark.parametrize("kw,match", [
        (dict(slow_enter=2.0, slow_exit=2.0), "slow_exit < slow_enter"),
        (dict(densify_enter=0.01, densify_exit=0.02), "densify"),
        (dict(grow_hi=0.5, grow_lo=0.9), "grow_lo < grow_hi"),
        (dict(cooldown_rounds=0), "cooldown"),
        (dict(max_codec_level=7), "max_codec_level"),
        (dict(densify_full_max=0), "densify_full_max"),
        (dict(evidence_every=0), "evidence_every"),
        (dict(link_net_frac=0.0), "link_net_frac"),
        (dict(link_net_frac=1.5), "link_net_frac")])
    def test_hysteresis_bands_enforced(self, kw, match):
        with pytest.raises(ValueError, match=match) as got:
            ControlConfig(**kw)
        with pytest.raises(ValueError) as want:
            RCtl.ControlConfig(**kw)
        assert str(got.value) == str(want.value)


class TestEvidence:
    def test_json_roundtrip_including_nan(self):
        ev = Evidence(rank=2, round=17, lag_s={3: 0.25, 1: 0.001},
                      states={3: 1}, reconnects={3: 2},
                      mixing_excess=float("nan"), consensus_growth=1.25)
        back = Evidence.from_json(ev.to_json())
        assert back.lag_s == {3: 0.25, 1: 0.001}
        assert back.reconnects == {3: 2}
        assert math.isnan(back.mixing_excess)
        assert back.consensus_growth == 1.25
        assert back.to_json() == ev.to_json() == _ref_ev(ev).to_json()

    def test_canonicalize_newest_round_per_rank_sorted(self):
        evs = [Evidence(rank=1, round=5), Evidence(rank=0, round=9),
               Evidence(rank=1, round=8), Evidence(rank=2, round=1)]
        out = canonicalize(evs)
        assert [e.rank for e in out] == [0, 1, 2]
        assert out[1].round == 8

    def test_records_roundtrip_and_torn_tolerated(self, tmp_path):
        d = str(tmp_path)
        write_evidence(d, Evidence(rank=0, round=3, lag_s={1: 0.1}))
        write_evidence(d, Evidence(rank=2, round=4))
        with open(os.path.join(d, "ctlev.1"), "w") as f:
            f.write('{"rank": 1, "rou')  # torn; ctlev.3 is missing
        out = read_evidence(d, 4)
        assert sorted(e.rank for e in out) == [0, 2]
        assert out[0].lag_s == {1: 0.1}

    def test_board_newest_round_wins(self):
        b = EvidenceBoard()
        b.publish(Evidence(rank=1, round=8, lag_s={0: 0.5}))
        b.publish(Evidence(rank=1, round=4, lag_s={0: 0.1}))
        (ev,) = b.snapshot()
        assert ev.round == 8 and ev.lag_s == {0: 0.5}

    def test_state_constants_match_resilience(self):
        from bluefog_tpu_torch.control import controller as C

        assert C._ST_SUSPECT == R.SUSPECT and C._ST_DEAD == R.DEAD

    def test_records_cross_read_between_packages(self, tmp_path):
        """Records one package writes, the other's ``read_evidence`` and
        ``canonicalize`` read into byte-equal canonical JSON, both ways."""
        rng = random.Random(5)
        for writer, reader in (("port", "ref"), ("ref", "port")):
            d = tmp_path / writer
            d.mkdir()
            evs = _random_evidence(rng, 6, 30)
            for ev in evs:
                if writer == "port":
                    write_evidence(str(d), ev)
                else:
                    RCtl.write_evidence(str(d), _ref_ev(ev))
            got = (read_evidence(str(d), 6) if reader == "port"
                   else RCtl.read_evidence(str(d), 6))
            got = (canonicalize(got) if reader == "port"
                   else RCtl.canonicalize(got))
            want = canonicalize(evs)
            assert [e.to_json() for e in got] == [e.to_json() for e in want]
            for r in range(6):
                with open(d / f"ctlev.{r}") as f:
                    assert f.read() == want[r].to_json()


# ---------------------------------------------------------------------------
# 2. plan convergence
# ---------------------------------------------------------------------------


def _random_evidence(rng, n, round_):
    evs = []
    for r in range(n):
        lag = {j: rng.choice([0.001, 0.003, 0.05, 0.4])
               for j in range(n) if j != r and rng.random() < 0.8}
        rec = {j: rng.choice([0, 0, 0, 1, 3])
               for j in lag if rng.random() < 0.3}
        evs.append(Evidence(
            rank=r, round=round_ + rng.randrange(3), lag_s=lag,
            states={j: rng.choice([0, 0, 1]) for j in lag},
            reconnects=rec,
            mixing_excess=rng.choice([float("nan"), -0.05, 0.3]),
            consensus_growth=rng.choice([float("nan"), 0.5, 0.9, 1.3]),
            phase_s={j: {"net": rng.choice([0.01, 0.3]),
                         "queue": rng.choice([0.01, 0.2]),
                         "apply": 0.01}
                     for j in lag if rng.random() < 0.2}))
    return evs


class TestPlanConvergence:
    def test_same_records_byte_identical_plans_and_the_reference(self):
        """8 controllers in each package, the same disseminated records in
        any order: one plan, byte for byte, and the JAX package's; over 30
        seeded evidence multisets and three decision generations."""
        n = 8
        cfg = ControlConfig(cooldown_rounds=2, min_lag_s=0.002,
                            max_codec_level=2)
        rcfg = _ref_cfg(cfg)
        for trial in range(30):
            rng = random.Random(1000 + trial)
            ctls = [CommController(r, n, config=cfg) for r in range(n)]
            rctls = [RCtl.CommController(r, n, config=rcfg)
                     for r in range(n)]
            for gen in range(3):
                rnd = 10 + gen * 10
                evs = _random_evidence(rng, n, rnd)
                blobs = set()
                for c, rc in zip(ctls, rctls):
                    shuffled = list(evs)
                    random.Random(trial * 100 + c.rank).shuffle(shuffled)
                    blobs.add(c.decide(rnd, shuffled).to_bytes())
                    blobs.add(rc.decide(
                        rnd, [_ref_ev(e) for e in shuffled]).to_bytes())
                assert len(blobs) == 1, (trial, gen, blobs)
                assert [c.plan_changes for c in ctls] == \
                    [c.plan_changes for c in rctls]

    def test_decide_plan_is_pure(self):
        evs = _random_evidence(random.Random(7), 4, 10)
        a = _decide(CommPlan(), 10, evs, ControlConfig())
        b = decide_plan(CommPlan(), 10, tuple(reversed(evs)),
                        ControlConfig())
        assert a.to_bytes() == b.to_bytes()


# ---------------------------------------------------------------------------
# 3. no-flap: hysteresis and cooldown
# ---------------------------------------------------------------------------


def _lag_evidence(n, round_, lag_of_3):
    return [Evidence(rank=r, round=round_,
                     lag_s={3: lag_of_3, (r + 1) % n: 0.01})
            for r in range(n) if r != 3]


class TestNoFlap:
    def test_oscillation_inside_band_never_flaps(self):
        n, cfg = 4, ControlConfig(cooldown_rounds=1, min_lag_s=0.001,
                                  slow_enter=4.0, slow_exit=2.0)
        c = CommController(0, n, config=cfg)
        for k in range(40):
            c.decide(k, _lag_evidence(n, k, 0.025 + 0.01 * (k % 2)))
        assert c.plan.version == 0, c.plan
        c.decide(50, _lag_evidence(n, 50, 0.5))
        assert c.plan.slow == (3,) and c.plan.version == 1
        for k in range(51, 90):
            c.decide(k, _lag_evidence(n, k, 0.025 + 0.01 * (k % 2)))
        assert c.plan.slow == (3,) and c.plan.version == 1

    def test_cooldown_bounds_change_rate(self):
        n, cool = 4, 8
        c = CommController(0, n, config=ControlConfig(
            cooldown_rounds=cool, min_lag_s=0.001))
        rc = RCtl.CommController(0, n, config=RCtl.ControlConfig(
            cooldown_rounds=cool, min_lag_s=0.001))
        for k in range(80):
            lag = 0.5 if (k // 2) % 2 == 0 else 0.001
            evs = _lag_evidence(n, k, lag)
            assert c.decide(k, evs).to_bytes() == rc.decide(
                k, [_ref_ev(e) for e in evs]).to_bytes()
        assert c.plan_changes <= 80 // cool + 1, c.plan_changes

    def test_cooldown_refuses_early_change(self):
        c = CommController(0, 4, config=ControlConfig(cooldown_rounds=16,
                                                      min_lag_s=0.001))
        p1 = c.decide(10, _lag_evidence(4, 10, 0.5))
        assert p1.version == 1
        assert c.decide(12, _lag_evidence(4, 12, 0.001)) is p1
        p3 = c.decide(26, _lag_evidence(4, 26, 0.001))
        assert p3.version == 2 and p3.slow == ()


# ---------------------------------------------------------------------------
# 4. the decision table
# ---------------------------------------------------------------------------


class TestDecisionTable:
    CFG = ControlConfig(cooldown_rounds=1, min_lag_s=0.001,
                        max_codec_level=2)

    def test_slow_enter_by_lag_ratio_median_of_reporters(self):
        assert _decide(CommPlan(), 10, _lag_evidence(4, 10, 0.5),
                       self.CFG).slow == (3,)

    def test_one_confused_reporter_cannot_convict(self):
        evs = [Evidence(rank=0, round=10, lag_s={3: 9.0, 1: 0.01}),
               Evidence(rank=1, round=10, lag_s={3: 0.01, 2: 0.01}),
               Evidence(rank=2, round=10, lag_s={3: 0.01, 0: 0.01})]
        assert _decide(CommPlan(), 10, evs, self.CFG).slow == ()

    def test_slow_enter_by_reconnect_delta(self):
        evs = [Evidence(rank=r, round=10, lag_s={(r + 1) % 4: 0.01},
                        reconnects={3: 1}) for r in range(3)]
        assert _decide(CommPlan(), 10, evs, self.CFG).slow == (3,)

    def test_release_requires_clean_lag_and_no_reconnects(self):
        prev = CommPlan(version=1, round=0, slow=(3,))
        evs = [Evidence(rank=r, round=10, lag_s={3: 0.001, 1: 0.01},
                        reconnects={3: 1}) for r in (0, 2)]
        assert _decide(prev, 10, evs, self.CFG).slow == (3,)
        evs = [Evidence(rank=r, round=20, lag_s={3: 0.001, 1: 0.01})
               for r in (0, 2)]
        assert _decide(prev, 20, evs, self.CFG).slow == ()

    def test_max_slow_frac_cap_prefers_worst(self):
        lags = {1: 0.5, 2: 0.9, 3: 0.7, 4: 0.001, 5: 0.001, 6: 0.001,
                7: 0.001}
        evs = [Evidence(rank=r, round=10,
                        lag_s={j: v for j, v in lags.items() if j != r})
               for r in range(8)]
        cfg = ControlConfig(cooldown_rounds=1, min_lag_s=0.001,
                            max_slow_frac=0.25)
        assert _decide(CommPlan(), 10, evs, cfg).slow == (2, 3)
        assert _decide(CommPlan(), 10, [evs[0]], cfg).slow == (2,)

    def test_slow_enter_by_majority_suspicion(self):
        evs = [Evidence(rank=r, round=10, lag_s={(r + 1) % 4: 0.01},
                        states={3: 1}) for r in range(3)]
        assert _decide(CommPlan(), 10, evs, self.CFG).slow == (3,)
        evs = [Evidence(rank=0, round=10, lag_s={1: 0.01}, states={3: 1}),
               Evidence(rank=1, round=10, lag_s={2: 0.01}),
               Evidence(rank=2, round=10, lag_s={0: 0.01})]
        assert _decide(CommPlan(), 10, evs, self.CFG).slow == ()

    def test_any_suspicion_holds_a_penalized_peer(self):
        prev = CommPlan(version=1, round=0, slow=(3,))
        evs = [Evidence(rank=r, round=20, lag_s={3: 0.001, 1: 0.01},
                        states={3: 1} if r == 0 else {}) for r in (0, 2)]
        assert _decide(prev, 20, evs, self.CFG).slow == (3,)

    def test_densify_ladder_up_and_down(self):
        p1 = _decide(CommPlan(), 10, [Evidence(
            rank=0, round=10, lag_s={1: 0.01}, mixing_excess=0.5)],
            self.CFG)
        assert p1.densify == 1
        p2 = _decide(p1, 20, [Evidence(
            rank=0, round=20, lag_s={1: 0.01}, mixing_excess=0.0)],
            self.CFG)
        assert p2.densify == 0

    def test_densify_top_rung_is_size_aware(self):
        cfg = ControlConfig(cooldown_rounds=1, min_lag_s=0.001,
                            densify_full_max=16)

        def evs(m, rnd):
            return [Evidence(rank=r, round=rnd, lag_s={1: 0.01},
                             mixing_excess=0.5) for r in range(m)]

        assert _decide(CommPlan(densify=1, version=1), 10, evs(8, 10),
                       cfg).densify == 2
        p = _decide(CommPlan(densify=1, version=1), 10, evs(64, 10), cfg)
        assert p.densify == 1
        assert _decide(p, 20, evs(64, 20), cfg).densify == 1
        assert _decide(CommPlan(densify=2, version=1), 30, evs(64, 30),
                       cfg).densify == 1

    def test_codec_backs_off_when_consensus_grows(self):
        plan = _decide(CommPlan(version=1, round=0, codec_level=2), 10,
                       [Evidence(rank=0, round=10, lag_s={1: 0.01},
                                 consensus_growth=1.5)], self.CFG)
        assert plan.codec_level == 1 and plan.gossip_every == 1

    def test_codec_rearms_toward_ceiling_when_contracting(self):
        plan = _decide(CommPlan(version=1, round=0, codec_level=0), 10,
                       [Evidence(rank=0, round=10, lag_s={1: 0.01},
                                 consensus_growth=0.5)], self.CFG)
        assert plan.codec_level == 1

    def test_codec_never_exceeds_config_ceiling(self):
        cfg = ControlConfig(cooldown_rounds=1, min_lag_s=0.001,
                            max_codec_level=0)
        plan = _decide(CommPlan(version=1, round=0, codec_level=2), 10,
                       [Evidence(rank=0, round=10, lag_s={1: 0.01},
                                 consensus_growth=0.5)], cfg)
        assert plan.codec_level == 0

    def test_cadence_stretches_only_under_slow_links(self):
        plan = _decide(CommPlan(), 10, [Evidence(
            rank=0, round=10, lag_s={1: 0.01}, consensus_growth=0.5)],
            self.CFG)
        assert plan.gossip_every == 1
        evs = [Evidence(rank=e.rank, round=e.round, lag_s=e.lag_s,
                        consensus_growth=0.5)
               for e in _lag_evidence(4, 20, 0.5)]
        plan2 = _decide(CommPlan(), 20, evs, self.CFG)
        assert plan2.slow == (3,) and plan2.gossip_every == 2

    def test_cadence_shrinks_when_consensus_grows(self):
        plan = _decide(CommPlan(version=1, round=0, gossip_every=4), 10,
                       [Evidence(rank=0, round=10, lag_s={1: 0.01},
                                 consensus_growth=1.5)], self.CFG)
        assert plan.gossip_every == 2

    def test_empty_or_stale_evidence_keeps_plan(self):
        prev = CommPlan(version=2, round=0, slow=(1,))
        assert decide_plan(prev, 50, [], self.CFG) is prev


def _phase_lag_evidence(n, round_, lag_of_3, phases, **kw):
    return [Evidence(rank=r, round=round_,
                     lag_s={3: lag_of_3, (r + 1) % n: 0.01},
                     phase_s={3: dict(phases)}, **kw)
            for r in range(n) if r != 3]


NET = {"net": 0.4, "queue": 0.05, "apply": 0.05}
HOST = {"net": 0.05, "queue": 0.35, "apply": 0.10}


class TestPhaseEvidence:
    CFG = ControlConfig(cooldown_rounds=1, min_lag_s=0.001,
                        max_codec_level=2)

    def test_evidence_phase_roundtrip_and_canonical(self):
        ev = Evidence(rank=0, round=9, lag_s={3: 0.5}, phase_s={3: NET})
        back = Evidence.from_json(ev.to_json())
        assert back.phase_s == {3: NET}
        assert back.to_json() == ev.to_json() == _ref_ev(ev).to_json()
        assert Evidence(rank=0, round=9,
                        phase_s={3: {"net": float("nan")}}).phase_s == {}

    def test_pre_tracing_record_parses_and_decides_identically(self):
        old = ('{"consensus_growth":null,"lag_s":{"1":0.01,"3":0.5},'
               '"mixing_excess":null,"rank":0,"reconnects":{},'
               '"round":10,"states":{}}')
        ev = Evidence.from_json(old)
        assert ev.phase_s == {}
        plan = _decide(CommPlan(), 10,
                       [ev] + _lag_evidence(4, 10, 0.5)[1:], self.CFG)
        assert plan.slow == (3,)

    def test_net_dominated_lag_routes_to_codec_not_spine(self):
        plan = _decide(CommPlan(), 10, _phase_lag_evidence(4, 10, 0.5, NET),
                       self.CFG)
        assert plan.slow == () and plan.codec_level == 1

    def test_host_dominated_lag_stays_spine_territory(self):
        plan = _decide(CommPlan(), 10,
                       _phase_lag_evidence(4, 10, 0.5, HOST), self.CFG)
        assert plan.slow == (3,) and plan.codec_level == 0

    def test_growth_backoff_does_not_cancel_link_remedy(self):
        plan = _decide(CommPlan(version=1, round=0, codec_level=1), 20,
                       _phase_lag_evidence(4, 20, 0.5, NET,
                                           consensus_growth=1.5), self.CFG)
        assert plan.codec_level == 0 and plan.slow == (3,)

    def test_grow_lo_rearm_already_is_the_link_remedy(self):
        plan = _decide(CommPlan(), 10,
                       _phase_lag_evidence(4, 10, 0.5, NET,
                                           consensus_growth=0.5), self.CFG)
        assert plan.slow == () and plan.codec_level == 1

    def test_no_codec_headroom_falls_back_to_spine(self):
        cfg = ControlConfig(cooldown_rounds=1, min_lag_s=0.001,
                            max_codec_level=0)
        assert _decide(CommPlan(), 10,
                       _phase_lag_evidence(4, 10, 0.5, NET),
                       cfg).slow == (3,)

    def test_lossy_or_suspected_is_never_diverted(self):
        evs = [Evidence(rank=r, round=10, lag_s={3: 0.5, 1: 0.01},
                        reconnects={3: 1},
                        phase_s={3: {"net": 0.4, "queue": 0.01,
                                     "apply": 0.01}}) for r in (0, 1, 2)]
        assert _decide(CommPlan(), 10, evs, self.CFG).slow == (3,)

    def test_byte_convergence_with_phase_records(self):
        evs = _phase_lag_evidence(4, 10, 0.5, NET)
        plans = set()
        for seed in range(6):
            shuffled = list(evs)
            random.Random(seed).shuffle(shuffled)
            plans.add(_decide(CommPlan(), 10, shuffled,
                              self.CFG).to_bytes())
        assert len(plans) == 1

    def test_controller_plumbs_phase_to_evidence(self):
        ctl = CommController(0, 4)
        ctl.note_peer(3, lag_s=0.5, phase_s=NET)
        ctl.note_peer(2, lag_s=0.01, phase_s=None)
        assert ctl.evidence(10).phase_s == {3: dict(sorted(NET.items()))}
        ctl.forget_peer(3)
        assert ctl.evidence(11).phase_s == {}

    def test_retain_peers_drops_stale_phase(self):
        ctl = CommController(0, 4)
        ctl.note_peer(3, phase_s={"net": 1.0})
        ctl.retain_peers([1, 2])
        assert ctl.evidence(5).phase_s == {}


def test_controller_feeds_evidence_as_the_reference():
    """The same observations through both packages' controllers give the
    same evidence records: reconnect deltas per window, the disagreement
    EWMA and its growth, forgotten peers."""
    cfg = ControlConfig()
    ctls = (CommController(1, 4, config=cfg),
            RCtl.CommController(1, 4, config=_ref_cfg(cfg)))
    rng = random.Random(3)
    for window in range(6):
        obs = [(j, rng.random() * 0.1, rng.choice([0, 1, 2]),
                window * 2 + rng.randrange(2)) for j in (0, 2, 3)]
        dis = [rng.random() for _ in range(3)]
        excess = rng.choice([None, 0.1, -0.2])
        recs = []
        for c in ctls:
            for j, lag, st, rec in obs:
                c.note_peer(j, lag_s=lag, state=st, reconnects_total=rec)
            for v in dis:
                c.note_disagreement(v)
            c.note_disagreement(float("nan"))
            c.note_mixing_excess(excess)
            if window == 4:
                c.retain_peers([0, 2])
            recs.append(c.evidence(10 + window).to_json())
        assert recs[0] == recs[1]
    assert ctls[0].disagreement == ctls[1].disagreement


# ---------------------------------------------------------------------------
# 5. the penalized replan
# ---------------------------------------------------------------------------


class TestPenalizedReplan:
    def test_deterministic_and_memoryless(self):
        base = T.ExponentialTwoGraph(8)
        a = T.replan_penalized(base, [0, 2, 4, 6], slow=[4], densify=1)
        b = T.replan_penalized(T.replan(base, [0, 1]), [0, 2, 4, 6],
                               slow=[4, 7], densify=1)
        np.testing.assert_allclose(a.weights, b.weights)
        assert b.name.count("+") == 1 and "+ctl(" in b.name

    def test_no_penalty_no_densify_is_replan(self):
        base = T.ExponentialTwoGraph(8)
        mem = [0, 1, 3, 5, 7]
        np.testing.assert_allclose(T.replan_penalized(base, mem).weights,
                                   T.replan(base, mem).weights)

    def test_slow_peer_degree_reduced_to_ring_spine(self):
        base = T.ExponentialTwoGraph(8)
        full = T.replan_penalized(base, range(8))
        pen = T.replan_penalized(base, range(8), slow=[3])
        assert pen.in_degree(3) == 1 and pen.out_degree(3) == 1
        assert pen.in_degree(3) < full.in_degree(3)
        assert pen.weights[3, 2] > 0 and pen.weights[4, 3] > 0

    def test_plan_topology_matches_the_reference(self):
        """Every plan a controller can actuate, over seeded member sets,
        slow sets and densify levels: the port's mixing matrix equals the
        JAX package's, rows stochastic, the active part strongly
        connected."""
        from bluefog_tpu import topology as RT
        from bluefog_tpu.analysis.topology_check import check_topology

        base, rbase = T.ExponentialTwoGraph(9), RT.ExponentialTwoGraph(9)
        rng = random.Random(42)
        for _ in range(40):
            m = rng.randrange(1, 10)
            members = sorted(rng.sample(range(9), m))
            plan = CommPlan(version=1, slow=tuple(rng.sample(
                range(9), rng.randrange(0, 5))), densify=rng.randrange(3))
            topo = plan_topology(base, members, plan)
            want = RCtl.plan_topology(
                rbase, members, RCtl.CommPlan.from_bytes(plan.to_bytes()))
            np.testing.assert_array_equal(topo.weights, want.weights)
            assert topo.inactive == want.inactive
            assert not [d for d in check_topology(want)
                        if d.severity == "error"]

    def test_plan_topology_ignores_nonmember_slow(self):
        topo = plan_topology(T.ExponentialTwoGraph(6), [0, 1, 2, 3],
                             CommPlan(version=1, slow=(2, 5)))
        assert topo.inactive == frozenset({4, 5})
        assert topo.in_degree(2) == 1


# ---------------------------------------------------------------------------
# 6. transport autotune, the stripe resize, and the tree plan
# ---------------------------------------------------------------------------


class TestTransportAutotune:
    def test_widen_on_slow_net_dominated_acks(self):
        from bluefog_tpu_torch.control import (TransportPlan,
                                               decide_transport_plan)

        p0 = TransportPlan()
        p1 = decide_transport_plan(p0, 10, ack_ewma_s=0.08, phase_s={
            "net": 0.06, "queue": 0.01, "apply": 0.01})
        assert (p1.stripes, p1.version) == (2, 1)
        assert p1.coalesce_bytes == p0.coalesce_bytes // 2

    def test_slow_host_is_not_widened_into(self):
        from bluefog_tpu_torch.control import (TransportPlan,
                                               decide_transport_plan)

        p0 = TransportPlan()
        assert decide_transport_plan(p0, 10, ack_ewma_s=0.08, phase_s={
            "net": 0.01, "queue": 0.03, "apply": 0.04}) is p0

    def test_hysteresis_band_never_flaps(self):
        from bluefog_tpu_torch.control import (TransportConfig,
                                               TransportPlan,
                                               decide_transport_plan)

        cfg = TransportConfig()
        plan = TransportPlan(version=3, round=0, stripes=2)
        for r, ack in enumerate([0.021, 0.049, 0.030, 0.045, 0.025],
                                start=cfg.cooldown_rounds):
            assert decide_transport_plan(plan, r, ack_ewma_s=ack,
                                         cfg=cfg) is plan

    def test_cooldown_freezes_a_fresh_plan(self):
        from bluefog_tpu_torch.control import (TransportPlan,
                                               decide_transport_plan)

        p1 = decide_transport_plan(TransportPlan(), 10, ack_ewma_s=0.08)
        assert p1.version == 1 and p1.round == 10
        assert decide_transport_plan(p1, 25, ack_ewma_s=0.5) is p1
        p3 = decide_transport_plan(p1, 26, ack_ewma_s=0.5)
        assert p3.version == 2 and p3.stripes == 4

    def test_narrow_on_recovery_and_floor_saturation(self):
        from bluefog_tpu_torch.control import (TransportPlan,
                                               decide_transport_plan)

        wide = TransportPlan(version=5, round=0, stripes=4,
                             coalesce_bytes=1 << 20)
        p1 = decide_transport_plan(wide, 100, ack_ewma_s=0.001)
        assert (p1.stripes, p1.version) == (2, 6)
        floor = TransportPlan(version=7, round=0, stripes=1,
                              coalesce_bytes=16 << 20)
        assert decide_transport_plan(floor, 100, ack_ewma_s=0.001) is floor

    def test_no_evidence_never_tunes(self):
        from bluefog_tpu_torch.control import (TransportPlan,
                                               decide_transport_plan)

        p0 = TransportPlan()
        assert decide_transport_plan(p0, 50, ack_ewma_s=None) is p0

    def test_plan_canonical_bytes_roundtrip(self):
        from bluefog_tpu_torch.control import TransportPlan

        p = TransportPlan(version=9, round=144, stripes=8,
                          coalesce_bytes=1 << 19)
        q = TransportPlan.from_bytes(p.to_bytes())
        assert p == q and p.to_bytes() == q.to_bytes()

    def test_config_validation_as_the_reference(self):
        from bluefog_tpu_torch.control import TransportConfig

        for kw in (dict(stripes_min=0), dict(stripes_min=4, stripes_max=2),
                   dict(coalesce_min_bytes=0),
                   dict(widen_enter_s=0.01, widen_exit_s=0.02),
                   dict(net_frac_enter=0.2, net_frac_exit=0.3),
                   dict(cooldown_rounds=-1)):
            with pytest.raises(ValueError) as got:
                TransportConfig(**kw)
            with pytest.raises(ValueError) as want:
                RCtl.TransportConfig(**kw)
            assert str(got.value) == str(want.value)

    def test_seeded_walks_match_the_reference(self):
        from bluefog_tpu_torch.control import (TransportConfig,
                                               TransportPlan,
                                               decide_transport_plan)

        rng = random.Random(11)
        cfg = TransportConfig(cooldown_rounds=3)
        rcfg = RCtl.TransportConfig(**dataclasses.asdict(cfg))
        for _ in range(20):
            p, rp = TransportPlan(), RCtl.TransportPlan()
            for rnd in range(0, 200, 2):
                ack = rng.choice([None, 0.001, 0.03, 0.08, 0.3])
                ph = rng.choice([None, {"net": 0.05, "queue": 0.01,
                                        "apply": 0.01},
                                 {"net": 0.01, "queue": 0.05,
                                  "apply": 0.01}])
                p = decide_transport_plan(p, rnd, ack_ewma_s=ack,
                                          phase_s=ph, cfg=cfg)
                rp = RCtl.decide_transport_plan(rp, rnd, ack_ewma_s=ack,
                                                phase_s=ph, cfg=rcfg)
                assert p.to_bytes() == rp.to_bytes()


@pytest.mark.parametrize("srv_side", ["port", "ref"])
def test_apply_plan_grow_shrink_never_strands_a_deposit(srv_side):
    """1 -> 4 -> 1 stripes between deposit rounds, against a port server
    and a JAX-package server: shrinking fences the closing stripes first,
    so every deposit lands once and the read-back is bit-exact."""
    from bluefog_tpu.runtime import async_windows as RA
    from bluefog_tpu.runtime import window_server as RW
    from bluefog_tpu_torch.control import TransportPlan
    from bluefog_tpu_torch.runtime import window_server as PW

    A, W = (aw, PW) if srv_side == "port" else (RA, RW)
    names = [_name(f"ctl_plan{i}") for i in range(4)]
    wins = {nm: A.AsyncWindow(nm, 1, 8, np.float64) for nm in names}
    srv = W.WindowServer()
    _, port = srv.start("127.0.0.1")
    st = PW.StripedDepositStream(("127.0.0.1", port), n_stripes=1)
    try:
        totals = {nm: np.zeros(8) for nm in names}

        def deposit_round(i):
            for nm in names:
                v = np.full(8, float(i + 1))
                st.deposit_async(nm.encode(), 0, v, accumulate=True)
                totals[nm] += v

        deposit_round(0)
        st.apply_plan(TransportPlan(version=1, round=1, stripes=4,
                                    coalesce_bytes=1 << 20))
        assert st.n_stripes == 4 and st.plan_version == 1
        deposit_round(1)
        st.apply_plan(TransportPlan(version=2, round=2, stripes=1,
                                    coalesce_bytes=4 << 20))
        assert st.n_stripes == 1
        deposit_round(2)
        st.flush(timeout_s=30)
        for nm in names:
            got, fresh = wins[nm].read(0, consume=False)
            np.testing.assert_array_equal(got, totals[nm])
            assert fresh == 3, nm
        assert st.wire_bytes == 12 * 8 * 8
    finally:
        st.close()
        srv.stop()
        for w in wins.values():
            w.free()


class TestTreePlan:
    def test_canonical_bytes_roundtrip(self):
        from bluefog_tpu_torch.control import TreePlan

        p = TreePlan(version=3, round=40, degree=8, depth=2, full_every=16)
        assert TreePlan.from_bytes(p.to_bytes()) == p
        assert p.to_bytes() == RCtl.TreePlan(
            version=3, round=40, degree=8, depth=2,
            full_every=16).to_bytes()

    def test_field_normalization_and_capacity(self):
        from bluefog_tpu_torch.control import TreePlan, tree_capacity

        p = TreePlan(degree=0, depth=-1, full_every=0)
        assert p.degree == 2 and p.depth == 0 and p.full_every == 1
        assert tree_capacity(8, 2) == 512 and tree_capacity(2, 0) == 2

    def test_decide_is_pure_and_order_independent(self):
        from bluefog_tpu_torch.control import (TreeConfig, TreeEvidence,
                                               TreePlan, decide_tree_plan)

        evs = [TreeEvidence("n0", tier=0, subscribers=60, skip_rate=0.01,
                            staleness_rounds=0.5),
               TreeEvidence("n1", tier=1, subscribers=8, skip_rate=0.4,
                            staleness_rounds=6.0)]
        a = decide_tree_plan(TreePlan(), 10, evs, TreeConfig())
        b = decide_tree_plan(TreePlan(), 10, list(reversed(evs)),
                             TreeConfig())
        assert a.to_bytes() == b.to_bytes() and a.version == 1

    def test_decision_table(self):
        from bluefog_tpu_torch.control import (TreeConfig, TreeEvidence,
                                               TreePlan, decide_tree_plan)

        cfg = TreeConfig(degree_max=8, full_every_max=32)
        prev = TreePlan(version=1, round=0, degree=8, depth=1, full_every=8)
        plan = decide_tree_plan(prev, 100, [TreeEvidence(
            "n0", subscribers=100, skip_rate=0.5, staleness_rounds=10.0)],
            cfg)
        assert (plan.degree, plan.full_every, plan.depth) == (4, 4, 2)
        plan2 = decide_tree_plan(plan, 200, [TreeEvidence(
            "n0", subscribers=3, skip_rate=0.0, staleness_rounds=0.1)], cfg)
        assert (plan2.degree, plan2.full_every, plan2.depth) == (8, 8, 1)
        assert decide_tree_plan(plan2, 300, [], cfg) is plan2

    def test_cooldown_and_no_flap(self):
        from bluefog_tpu_torch.control import (TreeConfig, TreeEvidence,
                                               TreePlan, decide_tree_plan)

        cfg = TreeConfig(cooldown_rounds=16)
        evs = [TreeEvidence("n0", subscribers=4, skip_rate=0.5,
                            staleness_rounds=0.2)]
        p1 = decide_tree_plan(TreePlan(), 10, evs, cfg)
        assert p1.version == 1
        assert decide_tree_plan(p1, 20, evs, cfg) is p1
        mid = [TreeEvidence("n0", subscribers=4, skip_rate=0.1,
                            staleness_rounds=2.0)]
        assert decide_tree_plan(p1, 40, mid, cfg) is p1

    def test_config_hysteresis_validation(self):
        from bluefog_tpu_torch.control import TreeConfig

        for kw, match in ((dict(skip_enter=0.01, skip_exit=0.05),
                           "skip_exit"),
                          (dict(stale_enter=1.0, stale_exit=2.0),
                           "stale_exit"),
                          (dict(fan_enter=0.1, fan_exit=0.2), "fan_exit")):
            with pytest.raises(ValueError, match=match):
                TreeConfig(**kw)

    def test_seeded_evidence_matches_the_reference(self):
        from bluefog_tpu_torch.control import (TreeConfig, TreeEvidence,
                                               TreePlan, decide_tree_plan)

        rng = random.Random(13)
        cfg = TreeConfig(cooldown_rounds=2)
        rcfg = RCtl.TreeConfig(**dataclasses.asdict(cfg))
        for _ in range(30):
            p, rp = TreePlan(), RCtl.TreePlan()
            for rnd in range(0, 60, 3):
                evs = [(f"n{k}", rng.randrange(3), rng.randrange(200),
                        rng.choice([float("nan"), 0.0, 0.1, 0.5]),
                        rng.choice([float("nan"), 0.2, 2.0, 9.0]))
                       for k in range(rng.randrange(4))]
                p = decide_tree_plan(p, rnd, [TreeEvidence(*e) for e in evs],
                                     cfg)
                rp = RCtl.decide_tree_plan(
                    rp, rnd, [RCtl.TreeEvidence(*e) for e in evs], rcfg)
                assert p.to_bytes() == rp.to_bytes()


# ---------------------------------------------------------------------------
# 7. MixingTracker
# ---------------------------------------------------------------------------


def _tracker_trace(mod_tracker, topos, rebase_to, distances):
    tr = mod_tracker(topos[0], rounds_per_update=2)
    out = [tr.predicted]
    for k, d in enumerate(distances):
        if k == len(distances) // 2:
            out.append(tr.rebase(rebase_to, rounds_per_update=3))
        if k == 3 * len(distances) // 4:
            tr.reset_measurement()
        m = tr.update(d)
        out.append(m)
        out.append(None if m is None or tr.predicted is None
                   else m - tr.predicted)
    return out


@pytest.mark.parametrize("case", ["ring", "healed-ring", "exp2-rebase"])
def test_mixing_tracker_matches_the_reference(case):
    from bluefog_tpu import topology as RT

    if case == "ring":
        topos = (T.RingGraph(6), RT.RingGraph(6))
        rebase = (T.RingGraph(6), RT.RingGraph(6))
    elif case == "healed-ring":
        topos = (T.heal(T.RingGraph(8), [5]), RT.heal(RT.RingGraph(8),
                                                      [5]))
        rebase = (T.heal(T.RingGraph(8), [2, 5]),
                  RT.heal(RT.RingGraph(8), [2, 5]))
    else:
        topos = (T.ExponentialTwoGraph(8), RT.ExponentialTwoGraph(8))
        rebase = (T.replan_penalized(T.ExponentialTwoGraph(8), range(8),
                                     slow=[3], densify=1),
                  RT.replan_penalized(RT.ExponentialTwoGraph(8), range(8),
                                      slow=[3], densify=1))
    dist = list(np.random.default_rng(4).random(12) + 0.1) + [0.0, 1.0]
    got = _tracker_trace(MixingTracker, (topos[0],), rebase[0], dist)
    want = _tracker_trace(RTracker, (topos[1],), rebase[1], dist)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert abs(g - w) <= 1e-12, (g, w)
    assert got[0] is not None and got[0] < 1.0


def test_mixing_tracker_on_a_matrix_and_bad_cadence():
    w = T.ExponentialTwoGraph(4).weights
    assert abs(MixingTracker(np.asarray(w)).predicted
               - RTracker(np.asarray(w)).predicted) <= 1e-12
    with pytest.raises(ValueError, match="rounds_per_update"):
        MixingTracker(rounds_per_update=0)
    assert MixingTracker("not a matrix").predicted is None


# ---------------------------------------------------------------------------
# 8. integration
# ---------------------------------------------------------------------------


def _zero_grad(rank, step, params):
    return 0.0, {k: torch.zeros_like(v) for k, v in params.items()}


class TestThreadIntegration:
    def test_slow_rank_penalized_audit_exact(self):
        rep = aw.run_async_dsgd(
            T.ExponentialTwoGraph(4), {"w": torch.arange(8.0)}, _zero_grad,
            duration_s=4.0, skew=[0.002, 0.002, 0.002, 0.25],
            name=_name("ctl_thread"),
            control=ControlConfig(evidence_every=4, cooldown_rounds=8,
                                  min_lag_s=0.02))
        assert abs(rep.total_mass - 4.0) < 1e-9 * 4, rep.total_mass
        assert rep.control_plan is not None
        assert 3 in rep.control_plan.slow, rep.control_plan
        assert rep.plan_changes >= 1
        assert rep.consensus_gap < 1e-6, rep.consensus_gap
        assert min(rep.steps_per_rank) >= 1

    def test_stop_after_steps_time_to_target(self):
        rep = aw.run_async_dsgd(
            T.FullyConnectedGraph(3), {"w": torch.zeros(4)}, _zero_grad,
            duration_s=30.0, skew=[0.001] * 3, name=_name("ctl_target"),
            stop_after_steps=25,
            control=ControlConfig(evidence_every=4, cooldown_rounds=8))
        assert rep.wall_time_s < 20.0
        assert max(rep.steps_per_rank) >= 25
        assert abs(rep.total_mass - 3.0) < 1e-9 * 3

    def test_chaos_killed_rank_evidence_stops_voting(self):
        PChaos.configure("rank2:die:at_step=30")
        rep = aw.run_async_dsgd(
            T.FullyConnectedGraph(4), {"w": torch.arange(8.0)}, _zero_grad,
            duration_s=3.0, skew=[0.002, 0.002, 0.002, 0.2],
            name=_name("ctl_corpse"),
            resilience=R.ResilienceConfig(suspect_after_s=0.2,
                                          dead_after_s=0.6),
            control=ControlConfig(evidence_every=4, cooldown_rounds=8,
                                  min_lag_s=0.02))
        assert rep.dead_ranks == [2]
        assert abs(rep.total_mass + rep.died_mass - 4.0) < 1e-9 * 4
        assert rep.control_plan is not None
        assert 2 not in rep.control_plan.slow or rep.plan_changes >= 1

    def test_cadence_and_overlap_keep_the_audit_exact(self):
        """A plan that stretches the gossip cadence (steps that keep their
        mass local) under compute/gossip overlap: still exact."""
        rep = aw.run_async_dsgd(
            T.ExponentialTwoGraph(4), {"w": torch.arange(8.0)}, _zero_grad,
            duration_s=2.5, skew=[0.002, 0.002, 0.002, 0.15],
            name=_name("ctl_overlap"), overlap=True,
            control=ControlConfig(evidence_every=4, cooldown_rounds=4,
                                  min_lag_s=0.02, grow_lo=0.99,
                                  grow_hi=1e9))
        assert abs(rep.total_mass - 4.0) < 1e-9 * 4, rep.total_mass
        assert rep.plan_changes >= 1


def _rank_call(tmp_path, **kw):
    return aw.run_async_dsgd_rank(
        T.FullyConnectedGraph(2), 0, {"w": torch.zeros(2)}, _zero_grad,
        barrier=aw.FileBarrier(str(tmp_path), 2, 0), tcp_bind="127.0.0.1",
        name=_name("ctl_arg"), **kw)


def test_control_requires_tcp_in_mp_mode(tmp_path):
    with pytest.raises(ValueError, match="tcp"):
        _rank_call(tmp_path, transport="shm", control=ControlConfig())


def test_control_requires_resilience_in_mp_mode(tmp_path):
    with pytest.raises(ValueError, match="resilience"):
        _rank_call(tmp_path, transport="tcp", control=ControlConfig())


def test_codec_ceiling_requires_matching_wire_codec(tmp_path):
    with pytest.raises(ValueError, match="wire_codec"):
        _rank_call(tmp_path, transport="tcp",
                   resilience=R.ResilienceConfig(),
                   control=ControlConfig(max_codec_level=2))


_MP_WORKER = r'''
import hashlib, json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, n, bdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
opts = json.loads(sys.argv[4])
if rank in opts.get("lossy", []):
    os.environ["BLUEFOG_TPU_CHAOS"] = opts["spec"]
from bluefog_tpu_torch.control import ControlConfig, controller
from bluefog_tpu_torch.runtime.async_windows import (FileBarrier,
                                                     run_async_dsgd_rank)

# every rank's last plan, for the byte-identity check across processes
final = {}
decide = controller.CommController.decide


def recording_decide(self, round_, evidences):
    final["plan"] = decide(self, round_, evidences)
    return final["plan"]


controller.CommController.decide = recording_decide
from bluefog_tpu_torch.runtime.resilience import ResilienceConfig
from bluefog_tpu_torch.topology import ExponentialTwoGraph


def loss_and_grad(r, step, params):
    return 0.0, {"w": torch.zeros_like(params["w"])}


rep = run_async_dsgd_rank(
    ExponentialTwoGraph(n), rank, {"w": torch.arange(64.0).double()},
    loss_and_grad, barrier=FileBarrier(bdir, n, rank),
    duration_s=opts["duration_s"], skew_s=opts["skew_s"],
    name="ctl_mp_" + os.path.basename(bdir), transport="tcp",
    tcp_bind="127.0.0.1",
    resilience=ResilienceConfig(barrier_timeout_s=60.0, reconnect_budget=8,
                                seed=rank),
    control=ControlConfig(**opts["control"]),
    stop_after_steps=opts["steps"], stream_options=opts["stream"])
# the run is over on every rank (the audit barrier): the disseminated
# records are final, and every process decides the same plan from them
from bluefog_tpu_torch.control import (CommPlan, decide_plan,
                                       read_evidence)
settled = decide_plan(CommPlan(), 10 ** 6, read_evidence(bdir, n),
                      ControlConfig(**opts["control"]))
with open(os.path.join(bdir, f"plan.{rank}"), "w") as f:
    json.dump({"live": final["plan"].to_bytes().decode(),
               "settled": hashlib.sha1(settled.to_bytes()).hexdigest()},
              f)
if rank == 0:
    with open(os.path.join(bdir, "report.json"), "w") as f:
        json.dump({"mass": rep.total_mass, "steps": rep.steps_per_rank,
                   "dead": rep.dead_ranks,
                   "plan": rep.control_plan.to_bytes().decode(),
                   "changes": rep.plan_changes,
                   "stats": rep.stream_stats}, f)
print(f"CTL_MP_OK {rank}", flush=True)
'''


def _run_mp(tmp_path, n, opts, timeout):
    script = tmp_path / "w.py"
    script.write_text(_MP_WORKER)
    bdir = tmp_path / "b"
    bdir.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("BLUEFOG_TPU_CHAOS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(n), str(bdir),
         json.dumps(opts)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"CTL_MP_OK {r}" in out, out
    return json.loads((bdir / "report.json").read_text()), bdir


def test_mp_control_with_ack_drops_three_processes(tmp_path):
    """3 processes over tcp with control and ``ack:drop`` on every
    server: the applied-but-unacked batches are resolved exactly once
    (the attach reply retires them, or the server dedups a replay), rank
    0's audit is exact, every process decides the byte-identical plan
    from the final disseminated records, and so does the JAX package."""
    import hashlib

    cfg = dict(evidence_every=4, cooldown_rounds=4, min_lag_s=0.02)
    opts = dict(lossy=[0, 1, 2], spec="ack:drop:every=5",
                duration_s=20.0, skew_s=0.002, steps=60,
                stream=dict(max_in_flight=2, max_queue_items=8),
                control=cfg)
    rep, bdir = _run_mp(tmp_path, 3, opts, timeout=60)
    assert abs(rep["mass"] - 3.0) <= 1e-9 * 3, rep["mass"]
    assert rep["dead"] == []
    assert min(rep["steps"]) >= 60, rep["steps"]
    stats = {k: sum(v[k] for v in rep["stats"].values())
             for k in ("reconnects", "retired", "deduped")}
    assert sorted(rep["stats"]) == ["0", "1", "2"]
    assert stats["reconnects"] >= 1, rep["stats"]
    assert stats["retired"] + stats["deduped"] >= 1, rep["stats"]
    plans = [json.loads((bdir / f"plan.{r}").read_text())
             for r in range(3)]
    assert len({p["settled"] for p in plans}) == 1, plans
    evs = read_evidence(str(bdir), 3)
    assert sorted(e.rank for e in evs) == [0, 1, 2]
    want = RCtl.decide_plan(RCtl.CommPlan(), 10 ** 6,
                            [_ref_ev(e) for e in evs],
                            _ref_cfg(ControlConfig(**cfg)))
    assert hashlib.sha1(want.to_bytes()).hexdigest() == plans[0]["settled"]


@pytest.mark.slow
@pytest.mark.chaos
def test_mp_lossy_link_controller_drops_edges_audit_exact(tmp_path):
    """The acceptance scenario of ``tests/_mp_control_worker.py``: 4 rank
    processes over tcp, rank 3's server behind a lossy, slow link; the
    controllers converge on a plan that penalizes rank 3 (or change the
    plan at least once), every rank reaches its step target, and rank 0's
    audit is exact."""
    opts = dict(lossy=[3], spec="server:delay:ms=40:rate=0.9:seed=1;"
                "server:drop:rate=0.02:seed=2", duration_s=45.0,
                skew_s=0.004, steps=250,
                stream=dict(max_in_flight=2, max_queue_items=8),
                control=dict(evidence_every=8, cooldown_rounds=16,
                             min_lag_s=0.02))
    rep, bdir = _run_mp(tmp_path, 4, opts, timeout=170)
    plans = [json.loads((bdir / f"plan.{r}").read_text())
             for r in range(4)]
    assert len({p["settled"] for p in plans}) == 1, plans
    plan = CommPlan.from_bytes(rep["plan"].encode())
    assert 3 in plan.slow or rep["changes"] >= 1, rep
    assert abs(rep["mass"] - 4.0) <= 1e-9 * 4, rep["mass"]
    assert min(rep["steps"]) >= 250, rep["steps"]
    assert rep["dead"] == []
