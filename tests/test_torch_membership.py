"""Elastic membership in the port against the JAX package: the roster
records (``member``/``leaving``/``left``/``dead`` files, tokens, ``scan``),
and ``replan``, ``replan_penalized`` and ``remap_topology`` weights, names
and inactive sets equal to the reference's over many member sets; heal and
replan compose as there."""

import os

import numpy as np
import pytest

from bluefog_tpu import topology as RT
from bluefog_tpu.runtime import membership as RM
from bluefog_tpu.topology import mapping as RMAP
from bluefog_tpu_torch import topology as PT
from bluefog_tpu_torch.runtime import membership as PM

BUILDERS = ["ExponentialTwoGraph", "FullyConnectedGraph", "RingGraph",
            "MeshGrid2DGraph", "StarGraph"]


def _same(p, r):
    np.testing.assert_array_equal(p.weights, r.weights)
    assert p.name == r.name
    assert p.inactive == r.inactive


def _member_sets(n, count, seed):
    rng = np.random.default_rng(seed)
    out = [list(range(n)), [0]]
    for _ in range(count):
        m = int(rng.integers(1, n + 1))
        out.append(sorted(rng.choice(n, size=m, replace=False).tolist()))
    return out


@pytest.mark.parametrize("n", [2, 5, 8, 9, 16])
@pytest.mark.parametrize("builder", BUILDERS)
def test_replan_equals_reference(builder, n):
    p0, r0 = getattr(PT, builder)(n), getattr(RT, builder)(n)
    for members in _member_sets(n, 12, n):
        _same(PT.replan(p0, members), RT.replan(r0, members))
        # shuffled and duplicated member lists land on the same matrix
        shuffled = list(reversed(members)) + members[:1]
        _same(PT.replan(p0, shuffled), RT.replan(r0, members))


@pytest.mark.parametrize("densify", [0, 1, 2, 5])
@pytest.mark.parametrize("n", [3, 6, 9, 12])
def test_replan_penalized_equals_reference(n, densify):
    p0, r0 = PT.ExponentialTwoGraph(n), RT.ExponentialTwoGraph(n)
    rng = np.random.default_rng(100 * n + densify)
    for members in _member_sets(n, 8, n + densify):
        k = int(rng.integers(0, len(members) + 1))
        slow = sorted(rng.choice(n, size=k, replace=False).tolist())
        _same(PT.replan_penalized(p0, members, slow=slow, densify=densify),
              RT.replan_penalized(r0, members, slow=slow, densify=densify))
    _same(PT.replan_penalized(p0, range(n), name="x"),
          RT.replan_penalized(r0, range(n), name="x"))


@pytest.mark.parametrize("builder", BUILDERS)
def test_remap_topology_equals_reference(builder):
    for n in (4, 7, 9):
        rng = np.random.default_rng(n)
        for _ in range(5):
            perm = rng.permutation(n).tolist()
            _same(PT.remap_topology(getattr(PT, builder)(n), perm),
                  RMAP.remap_topology(getattr(RT, builder)(n), perm))
    with pytest.raises(ValueError):
        PT.remap_topology(PT.RingGraph(4), [0, 1, 1, 2])


def test_ici_ring_order_is_re_exported():
    from bluefog_tpu_torch.parallel import axes
    from bluefog_tpu_torch.topology import mapping

    assert mapping.ici_ring_order is axes.ici_ring_order
    assert PT.ici_ring_order([3, 1, 2]) == [3, 1, 2]


def test_replan_errors_match():
    for mod in (PT, RT):
        t = mod.RingGraph(4)
        with pytest.raises(ValueError):
            mod.replan(t, [])
        with pytest.raises(ValueError):
            mod.replan(t, [0, 9])
        with pytest.raises(ValueError):
            mod.replan_penalized(t, [])


def test_heal_and_replan_names_collapse_as_in_the_reference():
    for mod in (PT, RT):
        t = mod.ExponentialTwoGraph(6)
        h = mod.heal(mod.heal(mod.heal(t, {1}), {2}), {3})
        assert h.name == "ExponentialTwoGraph+heal([1, 2, 3])"
        r = mod.replan(mod.replan(t, [0, 1, 2, 3]), [0, 2])
        assert r.name == "ExponentialTwoGraph+replan(n=2)"
        m = mod.heal(mod.replan(h, [0, 2, 4]), {4})
        assert m.name == "ExponentialTwoGraph+heal([1, 3, 4, 5])"
    _same(PT.heal(PT.replan(PT.ExponentialTwoGraph(6), [0, 2, 4]), {4}),
          RT.heal(RT.replan(RT.ExponentialTwoGraph(6), [0, 2, 4]), {4}))


def test_kill_rejoin_walks_match_reference():
    rng = np.random.default_rng(7)
    for builder in ("ExponentialTwoGraph", "RingGraph", "MeshGrid2DGraph"):
        p0, r0 = getattr(PT, builder)(9), getattr(RT, builder)(9)
        dead: set = set()
        for _ in range(12):
            if dead and rng.random() < 0.4:
                dead.discard(int(rng.choice(sorted(dead))))
            else:
                alive = sorted(set(range(9)) - dead)
                if len(alive) > 1:
                    dead.add(int(rng.choice(alive)))
            _same(PT.heal(p0, dead), RT.heal(r0, dead))
            live = sorted(set(range(9)) - dead)
            _same(PT.replan(p0, live), RT.replan(r0, live))


def test_records_and_scan_match_reference(tmp_path):
    d = str(tmp_path)
    PM.write_record(d, "member", 3, "tok-a")
    PM.write_record(d, "leaving", 1, "tok-b")
    PM.write_record(d, "left", 2, "tok-c")
    open(os.path.join(d, "dead.4"), "w").close()
    for r in (0, 1, 2, 3):
        open(os.path.join(d, f"winaddr.{r}"), "w").close()
    pv, rv = PM.scan(d, 6), RM.scan(d, 6)
    assert pv.announced == rv.announced == {3: "tok-a"}
    assert pv.leaving == rv.leaving == {1: "tok-b"}
    assert pv.left == rv.left == {2: "tok-c"}
    assert pv.dead == rv.dead == {4}
    assert pv.addressed == rv.addressed == {0, 1, 2, 3}
    assert pv.current_members() == rv.current_members() == {0, 1, 3}
    # the reference reads what the port writes and the other way round
    RM.write_record(d, "member", 5, "tok-r")
    assert PM.read_record(d, "member", 5) == "tok-r"
    assert RM.read_record(d, "leaving", 1) == "tok-b"
    assert PM.clear_record(d, "member", 5) is True
    assert PM.clear_record(d, "member", 5) is False
    assert RM.read_record(d, "member", 5) is None
    with pytest.raises(ValueError):
        PM.write_record(d, "bogus", 0)
    t1, t2 = PM.new_token(), PM.new_token()
    assert t1 != t2 and t1.startswith(f"{os.getpid()}-")


def test_joining_and_left_lanes_match_reference():
    from bluefog_tpu.runtime import resilience as RR
    from bluefog_tpu_torch.runtime import resilience as PR

    def lane(R):
        t = [0.0]
        board = R.HealthBoard(4, suspect_after_s=0.2, dead_after_s=0.5,
                              clock=lambda: t[0], members={0, 1, 2})
        out = [board.state(3)]
        t[0] = 10.0
        out.append(board.poll(3))  # an absent slot is not a silent one
        board.mark_joining(3)
        t[0] = 20.0
        out.append(board.poll(3))  # JOINING is sticky until admit
        board.admit(3)
        out.append(board.state(3))
        board.mark_left(1)
        t[0] = 40.0
        out.append(board.poll(1))
        board.mark_joining(1)
        board.admit(1)
        out.append(board.state(1))
        return out, [board.transitions(r) for r in range(4)]

    assert lane(PR) == lane(RR)
    assert lane(PR)[0] == [PR.LEFT, PR.LEFT, PR.JOINING, PR.HEALTHY,
                           PR.LEFT, PR.HEALTHY]
