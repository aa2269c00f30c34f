"""The port's peer-fault primitives against the JAX package's: ``Backoff``
schedules (seeded jitter, budgets, deadlines, worst-case totals), and the
``PeerHealth``/``HealthBoard`` state machines on a scripted clock, step for
step equal; plus ``heal`` and ``ResilienceConfig``, the ``FileBarrier``
exclusion set and the supervisor's backoff."""

import json
import os
import sys
import time

import numpy as np
import pytest

from bluefog_tpu import topology as RT
from bluefog_tpu.runtime import resilience as RR
from bluefog_tpu_torch import topology as PT
from bluefog_tpu_torch.runtime import resilience as PR


def test_states_and_names_match():
    for s in ("HEALTHY", "SUSPECT", "DEAD", "REJOINED", "JOINING", "LEFT"):
        assert getattr(PR, s) == getattr(RR, s)
    assert PR.STATE_NAMES == RR.STATE_NAMES


@pytest.mark.parametrize("kw", [
    dict(base_s=0.05, cap_s=1.0, budget=6, seed=7),
    dict(base_s=0.02, cap_s=0.2, budget=6, seed=0),
    dict(base_s=0.1, cap_s=0.4, factor=3.0, jitter=0.0, budget=5),
    dict(base_s=0.05, cap_s=2.0, factor=2.0, jitter=1.5, budget=8, seed=3),
    dict(base_s=0.01, budget=12, jitter=0.25, seed=11),
])
def test_backoff_schedule_equals_reference(kw):
    p, r = PR.Backoff(**kw), RR.Backoff(**kw)
    assert list(p) == list(r)
    assert p.attempts == r.attempts
    assert PR.Backoff(**kw).max_total_s() == RR.Backoff(**kw).max_total_s()


def test_backoff_bounds():
    bo = PR.Backoff(budget=2, jitter=0.0)
    bo.next_delay()
    bo.next_delay()
    with pytest.raises(PR.BudgetExhausted):
        bo.next_delay()
    with pytest.raises(ValueError):
        PR.Backoff(budget=None, deadline_s=None)
    with pytest.raises(ValueError):
        PR.Backoff(budget=0)
    bo = PR.Backoff(base_s=0.01, budget=None, deadline_s=0.0, jitter=0.0)
    bo.next_delay()
    time.sleep(0.01)
    with pytest.raises(PR.BudgetExhausted):
        bo.next_delay()


@pytest.mark.parametrize("overrides", [None, {}, dict(budget=2, seed=1),
                                       dict(base_s=0.5, jitter=0.0)])
def test_read_backoff_equals_reference(overrides):
    kw = dict(overrides or {})
    kw.setdefault("seed", 5)
    assert list(PR.read_backoff(kw)) == list(RR.read_backoff(kw))


def test_resilience_config_equals_reference():
    for kw in ({}, dict(reconnect_budget=3, seed=2, dead_after_s=0.7)):
        p, r = PR.ResilienceConfig(**kw), RR.ResilienceConfig(**kw)
        assert p.backoff_kwargs() == r.backoff_kwargs()
        assert p.detection_deadline_s() == r.detection_deadline_s()
        assert p.heartbeat_interval_s == r.heartbeat_interval_s
        assert p.barrier_timeout_s == r.barrier_timeout_s


def _scripted(mod, seed):
    """Run one seeded script of evidence and clock steps through a
    PeerHealth; returns its (state after each step) and transitions."""
    t = [0.0]
    h = mod.PeerHealth("peer", suspect_after_s=1.0, dead_after_s=3.0,
                       clock=lambda: t[0])
    rng = np.random.default_rng(seed)
    seen = []
    for _ in range(200):
        op = int(rng.integers(6))
        if op == 0:
            t[0] += float(rng.uniform(0.0, 2.0))
            seen.append(h.poll())
        elif op == 1:
            seen.append(h.note_ok())
        elif op == 2:
            seen.append(h.note_failure())
        elif op == 3:
            h.admit()
            seen.append(h.state)
        elif op == 4:
            h.mark_dead("scripted")
            seen.append(h.state)
        else:
            (h.mark_left if rng.random() < 0.5 else h.mark_joining)()
            seen.append(h.state)
    return seen, h.transitions, h.failures


@pytest.mark.parametrize("seed", range(6))
def test_peer_health_transitions_equal_reference(seed):
    assert _scripted(PR, seed) == _scripted(RR, seed)


def test_peer_health_cycle():
    t = [0.0]
    h = PR.PeerHealth("peer", suspect_after_s=1.0, dead_after_s=3.0,
                      clock=lambda: t[0])
    t[0] = 1.5
    assert h.poll() == PR.SUSPECT
    assert h.note_ok() == PR.HEALTHY
    t[0] = 10.0
    assert h.poll() == PR.DEAD
    assert h.note_ok() == PR.REJOINED
    t[0] = 20.0
    assert h.poll() == PR.REJOINED  # sticky until admit
    h.admit()
    assert h.state == PR.HEALTHY


def _board_script(mod, seed, n=4):
    t = [0.0]
    board = mod.HealthBoard(n, suspect_after_s=0.5, dead_after_s=1.0,
                            clock=lambda: t[0], members={0, 1, 2})
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(150):
        r = int(rng.integers(n))
        op = int(rng.integers(7))
        if op == 0:
            t[0] += float(rng.uniform(0.0, 0.8))
        elif op == 1:
            board.beat(r)
        elif op == 2:
            board.admit(r)
        elif op == 3:
            board.mark_joining(r)
        elif op == 4:
            board.mark_left(r)
        elif op == 5:
            board.mark_dead(r)
        log.append((sorted(board.dead_ranks()), sorted(board.rejoined_ranks()),
                    sorted(board.joining_ranks()), sorted(board.left_ranks()),
                    board.states(), board.poll(r)))
    return log, [board.transitions(r) for r in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_health_board_equals_reference(seed):
    assert _board_script(PR, seed) == _board_script(RR, seed)


@pytest.mark.parametrize("dead", [[3], [0, 2], [1]])
@pytest.mark.parametrize("builder", ["FullyConnectedGraph", "RingGraph",
                                     "ExponentialTwoGraph", "StarGraph"])
def test_heal_equals_reference(builder, dead):
    p = PT.heal(getattr(PT, builder)(5), dead)
    r = RT.heal(getattr(RT, builder)(5), dead)
    np.testing.assert_array_equal(p.weights, r.weights)
    assert p.name == r.name and p.inactive == r.inactive


def test_file_barrier_exclusion_and_rank_numbers(tmp_path):
    from bluefog_tpu_torch.runtime.async_windows import FileBarrier

    b = FileBarrier(str(tmp_path), 3, rank=0)
    open(os.path.join(str(tmp_path), "stage.1"), "w").close()
    b.exclude.add(2)  # a corpse: not waited for
    t0 = time.perf_counter()
    b.wait("stage", timeout_s=5.0)
    assert time.perf_counter() - t0 < 2.0
    b4 = FileBarrier(str(tmp_path / "x"), 4, rank=0)
    b4.exclude.add(3)
    with pytest.raises(TimeoutError, match=r"missing rank\(s\) \[1, 2\]"):
        b4.wait("audit", timeout_s=0.2)


_CRASH_ONCE = """\
import os, sys
marker = sys.argv[1]
if not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit(7)
sys.exit(0)
"""


def test_supervisor_restart_waits_with_backoff(tmp_path):
    from bluefog_tpu_torch.utils.failure import run_supervised

    script = tmp_path / "crash_once.py"
    script.write_text(_CRASH_ONCE)
    t0 = time.perf_counter()
    rc = run_supervised([sys.executable, str(script), str(tmp_path / "m")],
                        max_restarts=2, restart_backoff_s=0.4,
                        restart_jitter=0.0)
    assert rc == 0
    assert time.perf_counter() - t0 >= 0.4


def test_supervisor_gives_up_and_honours_min_uptime(tmp_path):
    from bluefog_tpu_torch.utils.failure import run_supervised

    script = tmp_path / "always.py"
    script.write_text("import sys; sys.exit(5)\n")
    assert run_supervised([sys.executable, str(script)], max_restarts=1,
                          restart_backoff_s=0.0) == 5
    # a crash faster than min_uptime earns no restart
    marker = tmp_path / "m2"
    script2 = tmp_path / "crash_once.py"
    script2.write_text(_CRASH_ONCE)
    assert run_supervised([sys.executable, str(script2), str(marker)],
                          max_restarts=3, min_uptime_s=60.0,
                          restart_backoff_s=0.0) == 7
    # incident_dir: every failed attempt leaves its restart marker
    incident = tmp_path / "incident"
    assert run_supervised([sys.executable, str(script)], max_restarts=1,
                          restart_backoff_s=0.0,
                          incident_dir=str(incident)) == 5
    marks = [json.loads(line) for line in
             (incident / "supervisor.jsonl").read_text().splitlines()]
    assert [(m["attempt"], m["returncode"]) for m in marks] == [(1, 5),
                                                                (2, 5)]
