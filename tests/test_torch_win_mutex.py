"""The port's ``win_mutex`` (``bluefog_tpu_torch/parallel/api.py``), the
lease cases of ``tests/test_win_mutex_lease.py`` on a real
``torch.distributed.TCPStore`` (the store ``bfrun`` hosts) in place of the
JAX package's coordination client: the stamp format, the three-part steal
rule, the break subkey, the heartbeat through transient store errors, the
janitor sweep; then one process (a reentrant local lock), several processes
without a store (an error, never a local lock), and two processes under
``bfrun``: a SIGKILLed holder's lock is stolen only after its lease, and a
live holder's never."""

import datetime
import os
import subprocess
import sys
import threading
import time
import uuid

import pytest
from torch.distributed import TCPStore

from bluefog_tpu.parallel import api as RA
from bluefog_tpu_torch.parallel import api as A

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def store():
    s = TCPStore("127.0.0.1", 0, 1, is_master=True, wait_for_workers=False,
                 timeout=datetime.timedelta(seconds=30))
    yield s


@pytest.fixture
def multi(monkeypatch, store):
    """This process as one of several, its store the fixture's."""
    monkeypatch.setattr(A, "_coordination_store", lambda: store)
    monkeypatch.setattr(A, "_dist_held", threading.local())
    return store


def _key(tag="t"):
    name = f"{tag}_{uuid.uuid4().hex[:8]}"
    return name, A._WIN_MUTEX_PREFIX + name


def stamp(owner, expiry, dur=None):
    s = f"{owner}{A._LEASE_MARK}{expiry:.3f}"
    return s + (f"/{dur:.1f}" if dur is not None else "")


def test_constants_and_stamp_format_are_the_reference():
    assert A._WIN_MUTEX_PREFIX == RA._WIN_MUTEX_PREFIX
    assert A._WIN_MUTEX_BREAK_PREFIX == RA._WIN_MUTEX_BREAK_PREFIX
    assert A._LEASE_MARK == RA._LEASE_MARK


@pytest.mark.parametrize("value", [
    stamp("0:1:2", 1234.5, 30.0), stamp("0:1:2", 1234.5), "999:1:1",
    stamp("7:4242:139684", 99.0, 5.0), "x lease_until=notanumber/3"])
def test_parse_equals_reference(value):
    assert A._parse_lock_value(value) == RA._parse_lock_value(value)


def test_store_get_acquire_release(store):
    _, key = _key()
    assert A._store_get(store, key) is None
    assert A._store_acquire(store, key, "a") is None
    assert A._store_acquire(store, key, "b") == "a"
    assert A._store_get(store, key) == "a"
    assert not A._store_release(store, key, "b")  # not the holder's value
    assert A._store_release(store, key, "a")
    assert A._store_get(store, key) is None
    assert A._store_acquire(store, key, "b") is None  # free again


class TestStealTracker:
    def test_never_steals_leaseless_values(self, store):
        _, key = _key()
        store.set(key, "999:1:1")  # hand-planted, no lease
        t = A._StealTracker(store, key, "me")
        for _ in range(3):
            t.poll()
            t.next_check = 0.0
            time.sleep(0.01)
        assert A._store_get(store, key) == "999:1:1"

    def test_never_steals_unexpired(self, store):
        _, key = _key()
        store.set(key, stamp("0:1:1", time.time() + 60, 30.0))
        t = A._StealTracker(store, key, "me")
        t.poll()
        t.next_check = 0.0
        t.poll()
        assert A._store_get(store, key) is not None

    def test_steals_only_after_confirmation_window(self, store):
        name, key = _key()
        store.set(key, stamp("0:1:1", time.time() - 5, 0.1))
        t = A._StealTracker(store, key, "me")
        t.poll()
        assert A._store_get(store, key) is not None, \
            "stole before watching a full lease"
        t.next_check = 0.0
        t.first_seen -= 2.0  # watched unchanged for 2 s
        t.poll()
        assert A._store_get(store, key) is None
        assert A._store_get(store, A._WIN_MUTEX_BREAK_PREFIX + name) is None

    def test_value_change_resets_confirmation(self, store):
        _, key = _key()
        store.set(key, stamp("0:1:1", time.time() - 5, 0.1))
        t = A._StealTracker(store, key, "me")
        t.poll()
        t.first_seen -= 2.0
        store.set(key, stamp("0:1:1", time.time() - 4.9, 0.1))  # refreshed
        t.next_check = 0.0
        t.poll()
        assert A._store_get(store, key) is not None

    def test_break_subkey_held_blocks_second_breaker(self, store):
        name, key = _key()
        store.set(key, stamp("0:1:1", time.time() - 5, 0.1))
        store.set(A._WIN_MUTEX_BREAK_PREFIX + name,
                  stamp("other", time.time() + 5))
        t = A._StealTracker(store, key, "me")
        t.poll()
        t.first_seen -= 2.0
        t.next_check = 0.0
        t.poll()
        assert A._store_get(store, key) is not None

    def test_stale_break_subkey_is_cleared(self, store):
        name, key = _key()
        bkey = A._WIN_MUTEX_BREAK_PREFIX + name
        v = stamp("0:1:1", time.time() - 5, 0.1)
        store.set(key, v)
        store.set(bkey, stamp("dead_breaker", time.time() - 1))
        assert A._break_stale(store, key, "me", v) is False
        assert A._store_get(store, bkey) is None

    def test_dotted_window_names_never_collide(self, store):
        name, key = _key()
        dotted = A._WIN_MUTEX_PREFIX + name + ".break"
        store.set(dotted, stamp("3:3:3", time.time() + 60, 30.0))
        v = stamp("0:1:1", time.time() - 5, 1.0)
        store.set(key, v)
        assert A._break_stale(store, key, "me", v) is True
        assert A._store_get(store, dotted) is not None


class TestBreakStale:
    def test_releases_only_unchanged_value(self, store):
        _, key = _key()
        observed = stamp("0:1:1", time.time() - 5, 1.0)
        store.set(key, stamp("2:2:2", time.time() + 60, 30.0))
        assert A._break_stale(store, key, "me", observed) is False
        assert A._store_get(store, key) is not None

    def test_releases_stale(self, store):
        _, key = _key()
        v = stamp("0:1:1", time.time() - 5, 1.0)
        store.set(key, v)
        assert A._break_stale(store, key, "me", v) is True
        assert A._store_get(store, key) is None


class _Flaky:
    """The store with its 3rd and 4th compare_set calls failing."""

    def __init__(self, store):
        self._s = store
        self.calls = 0

    def compare_set(self, *a):
        self.calls += 1
        if self.calls in (3, 4):
            raise RuntimeError("transient store error")
        return self._s.compare_set(*a)

    def __getattr__(self, name):
        return getattr(self._s, name)


def test_transient_store_errors_do_not_kill_the_refresher(monkeypatch,
                                                          store):
    flaky = _Flaky(store)
    monkeypatch.setattr(A, "_coordination_store", lambda: flaky)
    monkeypatch.setattr(A, "_dist_held", threading.local())
    name, key = _key("hb")
    stamps = []
    with A.win_mutex(name, lease_s=0.3):
        deadline = time.monotonic() + 1.2
        while time.monotonic() < deadline:
            v = A._store_get(store, key)
            if v is not None:
                stamps.append(v)
            time.sleep(0.05)
    assert len(set(stamps)) >= 3, set(stamps)  # it kept re-stamping
    assert A._store_get(store, key) is None  # released cleanly


def test_distributed_lock_is_reentrant_and_released(multi):
    name, key = _key("re")
    with A.win_mutex(name, lease_s=5.0):
        owner = A._parse_lock_value(A._store_get(multi, key))[0]
        assert owner.endswith(f":{os.getpid()}:{threading.get_ident()}")
        with A.win_mutex(name, lease_s=5.0):
            pass
        assert A._store_get(multi, key) is not None  # still held
    assert A._store_get(multi, key) is None


def test_contended_lock_times_out_loudly(multi):
    name, key = _key("to")
    multi.set(key, stamp("9:9:9", time.time() + 60, 30.0))
    with pytest.raises(TimeoutError, match="win_mutex_break"):
        with A.win_mutex(name, timeout_s=0.2):
            pass
    assert A.win_mutex_break(name) is True
    assert A._store_get(multi, key) is None
    assert A.win_mutex_break(name) is False


class TestSweep:
    def test_sweep_uses_fresh_reads_and_break_protocol(self, multi):
        now = time.time()
        names = {tag: _key(tag) for tag in ("dead", "live", "legacy")}
        multi.set(names["dead"][1], stamp("1:1:1", now - 60, 5.0))
        multi.set(names["live"][1], stamp("2:2:2", now + 60, 30.0))
        multi.set(names["legacy"][1], "3:3:3")
        for name, _ in names.values():
            multi.append(A._WIN_MUTEX_REGISTRY, name + "\n")
        assert A.win_mutex_sweep() >= 1
        assert A._store_get(multi, names["dead"][1]) is None
        assert A._store_get(multi, names["live"][1]) is not None
        assert A._store_get(multi, names["legacy"][1]) == "3:3:3"
        for name, _ in names.values():
            assert A._store_get(
                multi, A._WIN_MUTEX_BREAK_PREFIX + name) is None

    def test_sweep_grace(self, multi):
        name, key = _key("recent")
        multi.set(key, stamp("1:1:1", time.time() - 2, 5.0))
        multi.append(A._WIN_MUTEX_REGISTRY, name + "\n")
        assert A._store_get(multi, key) is not None
        A.win_mutex_sweep(grace_s=10.0)
        assert A._store_get(multi, key) is not None
        A.win_mutex_sweep(grace_s=1.0)
        assert A._store_get(multi, key) is None


def test_one_process_is_a_reentrant_local_lock(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    seen = []
    with A.win_mutex("local"):
        with A.win_mutex("local"):
            t = threading.Thread(target=lambda: seen.append(
                A._win_mutexes["local"].acquire(timeout=0.1)))
            t.start()
            t.join()
    assert seen == [False]  # another thread waits while it is held
    assert A.win_mutex_sweep() == 0 and A.win_mutex_break("local") is False


def test_several_processes_without_a_store_raise(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setattr(A, "_store_cache", [])
    with pytest.raises(RuntimeError, match="refusing to downgrade"):
        with A.win_mutex("nostore"):
            pass


_WORKER = r'''
import os, signal, subprocess, sys, time

mode, d = sys.argv[1], sys.argv[2]
rank = int(os.environ["RANK"])
held = os.path.join(d, "held")
if mode == "holder":
    # the lock holder: stamps a lease, publishes its acquisition time,
    # then dies with the lock held (or, "live", keeps it past its lease)
    from bluefog_tpu_torch.parallel import api as A

    kind = sys.argv[3]
    lease = 1.0 if kind == "live" else 2.0
    cm = A.win_mutex("shared", lease_s=lease)
    cm.__enter__()
    with open(held + ".tmp", "w") as f:
        f.write(repr(time.time()))
    os.replace(held + ".tmp", held)
    if kind == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(3.0)  # three leases, kept alive by the heartbeat
    with open(os.path.join(d, "released"), "w") as f:
        f.write(repr(time.time()))
    cm.__exit__(None, None, None)
    sys.exit(0)
if rank == 0:
    # a child of rank 0 holds the lock, so its SIGKILL does not stop the
    # launcher's group
    rc = subprocess.call([sys.executable, __file__, "holder", d,
                          sys.argv[3]])
    assert rc == (-signal.SIGKILL if sys.argv[3] == "kill" else 0), rc
    sys.exit(0)
from bluefog_tpu_torch.parallel import api as A

while not os.path.exists(held):
    time.sleep(0.01)
t_held = float(open(held).read())
with A.win_mutex("shared", timeout_s=30.0):
    t_got = time.time()
print(f"WAITED {t_got - t_held!r}", flush=True)
if sys.argv[3] == "live":
    t_rel = float(open(os.path.join(d, "released")).read())
    assert t_got >= t_rel, (t_got, t_rel)
'''


@pytest.mark.parametrize("kind", ["kill", "live"])
def test_two_processes_under_bfrun(tmp_path, kind):
    """A SIGKILLed holder's lock is stolen only after its 2 s lease (and
    the contender's full-lease watch); a live holder keeps its 1 s lease
    alive for 3 s and the contender gets the lock only at its release."""
    script = tmp_path / "w.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch", "-np",
         "2", "--no-build", str(script), "contend", str(tmp_path), kind],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    waited = float(out.stdout.split("WAITED ")[1].split()[0])
    if kind == "kill":
        assert 2.0 <= waited < 15.0, waited
    else:
        assert waited >= 2.9, waited


def test_run_with_restart_sweeps_expired_leases_between_attempts(multi,
                                                                  tmp_path):
    """The restart path's janitor: a lock the failed attempt died holding
    (its lease expired) is cleared before the next attempt."""
    import torch

    from bluefog_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    run_with_restart)

    name, key = _key("janitor")
    seen = []

    def train(state, start):
        seen.append(A._store_get(multi, key))
        if len(seen) == 1:
            multi.set(key, stamp("dead:1:1", time.time() - 60, 5.0))
            multi.append(A._WIN_MUTEX_REGISTRY, name + "\n")
            raise RuntimeError("the attempt died holding the lock")
        return state

    state = {"w": torch.zeros(1, 2)}
    run_with_restart(train, CheckpointManager(str(tmp_path)), state,
                     max_restarts=1)
    assert seen == [None, None]  # swept before the second attempt
