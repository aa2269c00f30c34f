"""The port's lock-order tripwire (``bluefog_tpu_torch/utils/lockcheck.py``)
against the JAX package's (``bluefog_tpu/utils/lockcheck.py``), following
``tests/test_lockcheck.py``:

- ``TestTripwireUnit``'s cases, each a scenario run on both modules: the
  same edges (with their ``same_class`` and ``closes_cycle`` flags), the
  same cycles and the same violations (their thread names and stacks
  aside), and the reference test's own assertions on the port;
- ``TestEnvArm``'s cases: a subprocess started with
  ``BLUEFOG_TPU_LOCKCHECK=1`` (or ``warn``, ``0``) runs checked or not
  with no code change.

Left out: ``test_cycle_records_blackbox_event`` (the flight recorder is
not ported yet, ROADMAP item 11a-ii) and ``TestRuntimeUnderTripwire``
(no ported module takes its locks from lockcheck yet, item 11a-ii).
"""

import subprocess
import sys
import threading
import time

import pytest

from bluefog_tpu.utils import lockcheck as RL
from bluefog_tpu_torch.utils import lockcheck as PL
from tests._util import REPO, clean_env


@pytest.fixture(autouse=True)
def _tripwires_isolated():
    """Every case starts with clean edge tables and ends disarmed."""
    for lc in (PL, RL):
        lc.disable()
        lc.reset()
    yield
    for lc in (PL, RL):
        lc.disable()
        lc.reset()


def _multinode_cycles(lc):
    return [c for c in lc.cycles() if len(c) > 1]


def _state(lc):
    """The observable table of a module: edges with their flags, cycles,
    and violations without the thread names and stacks that differ by
    process history.  The JAX package records a cycle in its flight
    recorder while the offending locks are held, which adds edges into
    the recorder's own locks (``blackbox.*``); the port has no flight
    recorder yet, so those edges are set aside."""
    edges = {k: {f: v for f, v in e.items() if f not in ("thread", "stack")}
             for k, e in lc.edges().items()
             if not k[1].startswith("blackbox.")}
    viol = [{f: v for f, v in e.items() if f not in ("thread", "stack")}
            for e in lc.violations()]
    return edges, lc.cycles(), viol


def _in_thread(fn):
    out = []

    def run():
        try:
            fn()
        except Exception as e:  # noqa: BLE001 (handed to the caller)
            out.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    return out


# ---------------------------------------------------------------------------
# TestTripwireUnit's cases as scenarios
# ---------------------------------------------------------------------------


def _off_mode_is_transparent(lc):
    a, b = lc.lock("off.a"), lc.lock("off.b")
    with a:
        with b:
            pass
    with b:
        with a:  # ABBA, but the tripwire is off
            pass
    assert lc.edges() == {}
    assert lc.violations() == []


def _abba_cycle_detected_deterministically(lc):
    # thread 1 teaches the table A -> B and exits; thread 2 then attempts
    # B -> A, caught at the acquire (no real deadlock, no timing window)
    lc.enable()
    a, b = lc.lock("abba.a"), lc.lock("abba.b")

    def forward():
        with a:
            with b:
                pass

    assert _in_thread(forward) == []
    assert ("abba.a", "abba.b") in lc.edges()

    def backward():
        with b:
            with a:
                pass

    caught = _in_thread(backward)
    assert len(caught) == 1 and isinstance(caught[0],
                                           lc.LockOrderViolation), caught
    assert "ABBA" in str(caught[0])
    v = lc.violations()
    assert v and v[0]["held"] == "abba.b" and v[0]["wanted"] == "abba.a"


def _warn_mode_records_without_raising(lc):
    lc.enable(raise_on_cycle=False)
    a, b = lc.lock("warn.a"), lc.lock("warn.b")
    with a:
        with b:
            pass
    with b:
        with a:  # inversion recorded, not raised
            pass
    assert len(lc.violations()) == 1
    assert _multinode_cycles(lc) == [["warn.a", "warn.b"]]


def _plain_lock_self_reacquire_raises_before_blocking(lc):
    # blocking on a plain lock the thread already holds can never succeed:
    # the tripwire raises, even in warn mode
    lc.enable(raise_on_cycle=False)
    mu = lc.lock("selfdead.mu")
    with mu:
        with pytest.raises(lc.LockOrderViolation, match="self-deadlock"):
            mu.acquire()
    v = lc.violations()
    assert v and v[0].get("self_deadlock") is True
    assert v[0]["held"] == "selfdead.mu"


def _rlock_reentry_is_not_an_edge(lc):
    lc.enable()
    r = lc.rlock("re.r")
    with r:
        with r:  # legal reentry: no self-edge, no violation
            pass
    assert lc.edges() == {}


def _timed_acquire_adds_no_edge_but_holds(lc):
    lc.enable()
    a, b = lc.lock("timed.a"), lc.lock("timed.b")
    with a:
        assert b.acquire(timeout=1.0)  # a deadline cannot deadlock
        b.release()
    assert ("timed.a", "timed.b") not in lc.edges()
    # a blocking acquire under a timed hold still records the held lock
    # as the edge's source (holding is holding)
    assert b.acquire(timeout=1.0)
    try:
        with a:
            pass
    finally:
        b.release()
    assert ("timed.b", "timed.a") in lc.edges()


def _same_class_instances_report_but_never_raise(lc):
    lc.enable()
    p1, p2 = lc.lock("peer.cv"), lc.lock("peer.cv")
    with p1:
        with p2:
            pass
    assert lc.edges()[("peer.cv", "peer.cv")]["same_class"] is True
    assert lc.violations() == []


def _condvar_wait_keeps_held_set_honest(lc):
    # across cv.wait() the underlying lock is released and re-acquired;
    # locks the waiter still holds order before the re-acquire, and the
    # held set balances to empty
    lc.enable()
    outer = lc.lock("cvh.outer")
    cv = lc.condition("cvh.cv")
    done = threading.Event()

    def waiter():
        with outer:
            with cv:
                cv.wait(timeout=0.5)
        done.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify_all()
    t.join(timeout=5)
    assert done.is_set()
    assert ("cvh.outer", "cvh.cv") in lc.edges()
    assert _multinode_cycles(lc) == []


def _reset_clears_the_table(lc):
    lc.enable()
    a, b = lc.lock("rst.a"), lc.lock("rst.b")
    with a:
        with b:
            pass
    assert lc.edges()
    lc.reset()
    assert lc.edges() == {}
    assert lc.violations() == []


def _locks_created_before_enable_are_tracked(lc):
    a, b = lc.lock("late.a"), lc.lock("late.b")
    lc.enable()
    with a:
        with b:
            pass
    assert ("late.a", "late.b") in lc.edges()


def _three_lock_cycle_closes_at_the_third_edge(lc):
    # beyond the reference's cases: a cycle through three classes is
    # caught at the edge that closes it, and cycles() names all three
    lc.enable(raise_on_cycle=False)
    a, b, c = lc.lock("tri.a"), lc.lock("tri.b"), lc.lock("tri.c")
    for x, y in ((a, b), (b, c), (c, a)):
        with x:
            with y:
                pass
    assert _multinode_cycles(lc) == [["tri.a", "tri.b", "tri.c"]]
    (v,) = lc.violations()
    assert (v["held"], v["wanted"]) == ("tri.c", "tri.a")
    assert lc.edges()[("tri.c", "tri.a")]["closes_cycle"] is True


SCENARIOS = {
    "off_mode_is_transparent": _off_mode_is_transparent,
    "abba_cycle_detected_deterministically":
        _abba_cycle_detected_deterministically,
    "warn_mode_records_without_raising": _warn_mode_records_without_raising,
    "plain_lock_self_reacquire_raises_before_blocking":
        _plain_lock_self_reacquire_raises_before_blocking,
    "rlock_reentry_is_not_an_edge": _rlock_reentry_is_not_an_edge,
    "timed_acquire_adds_no_edge_but_holds":
        _timed_acquire_adds_no_edge_but_holds,
    "same_class_instances_report_but_never_raise":
        _same_class_instances_report_but_never_raise,
    "condvar_wait_keeps_held_set_honest": _condvar_wait_keeps_held_set_honest,
    "reset_clears_the_table": _reset_clears_the_table,
    "locks_created_before_enable_are_tracked":
        _locks_created_before_enable_are_tracked,
    "three_lock_cycle_closes_at_the_third_edge":
        _three_lock_cycle_closes_at_the_third_edge,
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_tripwire_case_matches_the_jax_package(case):
    """Each case holds on the port, and leaves the same table as on the
    JAX package's tripwire."""
    SCENARIOS[case](PL)
    port = _state(PL)
    SCENARIOS[case](RL)
    assert port == _state(RL)


def test_module_surface_matches_the_jax_package():
    assert PL.__all__ == RL.__all__
    for name in PL.__all__:
        assert hasattr(PL, name), name
    assert issubclass(PL.LockOrderViolation, RuntimeError)


@pytest.mark.parametrize("value,mode", [
    ("", None), ("0", None), ("off", None), ("false", None),
    ("warn", "warn"), ("record", "warn"), ("1", "raise"), ("raise", "raise"),
    ("yes", "raise")])
def test_env_mode_parses_like_the_jax_package(monkeypatch, value, mode):
    monkeypatch.setenv("BLUEFOG_TPU_LOCKCHECK", value)
    assert PL._env_mode() == RL._env_mode() == mode


def test_off_lock_is_a_thin_proxy():
    """Disarmed, a tracked lock delegates to a plain ``threading`` lock:
    nothing recorded, the held set untouched after a release."""
    lk = PL.lock("thin.a")
    assert type(lk._inner) is type(threading.Lock())
    assert lk.acquire() and lk.locked()
    lk.release()
    assert not lk.locked()
    assert PL._held() == [] and PL.edges() == {}


# ---------------------------------------------------------------------------
# TestEnvArm: BLUEFOG_TPU_LOCKCHECK arms a subprocess with no code change
# ---------------------------------------------------------------------------


_TRAP = (
    "import threading\n"
    "from bluefog_tpu_torch.utils import lockcheck\n"
    "assert lockcheck.enabled()\n"
    "a = lockcheck.lock('env.a'); b = lockcheck.lock('env.b')\n"
    "t = threading.Thread(target=lambda: (a.acquire(), "
    "b.acquire(), b.release(), a.release()))\n"
    "t.start(); t.join()\n"
    "hit = []\n"
    "def inv():\n"
    "    try:\n"
    "        with b:\n"
    "            with a:\n"
    "                pass\n"
    "    except lockcheck.LockOrderViolation:\n"
    "        hit.append(1)\n"
    "t2 = threading.Thread(target=inv); t2.start(); t2.join()\n"
    "print('TRAPPED' if hit else 'RECORDED', "
    "len(lockcheck.violations()))\n"
)


def _run(code, value):
    env = clean_env()
    env["BLUEFOG_TPU_LOCKCHECK"] = value
    return subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO, env=env)


@pytest.mark.parametrize("value,expect", [("1", "TRAPPED 1"),
                                          ("warn", "RECORDED 1")])
def test_env_var_arms_and_traps_in_subprocess(value, expect):
    proc = _run(_TRAP, value)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert expect in proc.stdout


def test_env_off_means_off():
    proc = _run("from bluefog_tpu_torch.utils import lockcheck\n"
                "assert not lockcheck.enabled()\n"
                "print('OFF')\n", "0")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OFF" in proc.stdout
