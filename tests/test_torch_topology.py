"""Topologies and gossip schedules of the port against the JAX package's.

Both are numpy-only, so the comparison is exact: equal weight matrices,
slot permutations and per-rank tables for every ported constructor at
n = 1..16.
"""

import numpy as np
import pytest

import bluefog_tpu.topology as jt
import bluefog_tpu_torch.topology as pt

SIZES = range(1, 17)

CONSTRUCTORS = {
    "exp2": lambda m, n: m.ExponentialTwoGraph(n),
    "exp_base2": lambda m, n: m.ExponentialGraph(n),
    "exp_base3": lambda m, n: m.ExponentialGraph(n, base=3),
    "sym_exp": lambda m, n: m.SymmetricExponentialGraph(n),
    "sym_exp_base2": lambda m, n: m.SymmetricExponentialGraph(n, base=2),
    "ring": lambda m, n: m.RingGraph(n),
    "ring_right": lambda m, n: m.RingGraph(n, connect_style=1),
    "ring_left": lambda m, n: m.RingGraph(n, connect_style=2),
    "grid": lambda m, n: m.MeshGrid2DGraph(n),
    "star": lambda m, n: m.StarGraph(n),
    "star_center_last": lambda m, n: m.StarGraph(n, center_rank=n - 1),
    "full": lambda m, n: m.FullyConnectedGraph(n),
}


def _assert_same_schedule(js, ps):
    assert ps.size == js.size
    assert ps.perms == js.perms
    assert ps.is_circulant == js.is_circulant
    assert ps.name == js.name
    np.testing.assert_array_equal(ps.self_weights, js.self_weights)
    np.testing.assert_array_equal(ps.recv_weights, js.recv_weights)
    np.testing.assert_array_equal(ps.recv_src, js.recv_src)
    assert ps.recv_src.dtype == js.recv_src.dtype
    np.testing.assert_array_equal(ps.mixing_matrix(), js.mixing_matrix())


@pytest.mark.parametrize("kind", sorted(CONSTRUCTORS))
def test_constructor_weights_and_schedule_match(kind):
    make = CONSTRUCTORS[kind]
    for n in SIZES:
        jtopo, ptopo = make(jt, n), make(pt, n)
        np.testing.assert_array_equal(ptopo.weights, jtopo.weights,
                                      err_msg=f"{kind} n={n}")
        assert ptopo.name == jtopo.name
        assert ptopo.edges == jtopo.edges
        assert ptopo.max_in_degree == jtopo.max_in_degree
        for r in range(n):
            assert pt.GetRecvWeights(ptopo, r) == jt.GetRecvWeights(jtopo, r)
            assert pt.GetSendWeights(ptopo, r) == jt.GetSendWeights(jtopo, r)
            assert ptopo.in_neighbors(r) == jtopo.in_neighbors(r)
            assert ptopo.out_neighbors(r) == jtopo.out_neighbors(r)
        assert pt.IsRegularGraph(ptopo) == jt.IsRegularGraph(jtopo)
        _assert_same_schedule(jt.build_schedule(jtopo),
                              pt.build_schedule(ptopo))


def test_exp2_of_8_is_three_circulant_shifts_of_one_quarter():
    sched = pt.build_schedule(pt.ExponentialTwoGraph(8))
    assert sched.is_circulant
    shifts = [(perm[0][1] - perm[0][0]) % 8 for perm in sched.perms]
    assert shifts == [1, 2, 4]
    np.testing.assert_array_equal(sched.recv_weights, np.full((8, 3), 0.25))
    np.testing.assert_array_equal(sched.self_weights, np.full(8, 0.25))
    # slot k of rank i receives from (i - s_k) mod n
    for i in range(8):
        assert list(sched.recv_src[i]) == [(i - s) % 8 for s in shifts]


@pytest.mark.parametrize("weights", [None, "custom"])
def test_from_edges_matches(weights):
    edges = [(0, 1), (1, 2), (2, 0), (0, 3), (3, 1)]
    w = None if weights is None else {e: 0.1 * (i + 1)
                                      for i, e in enumerate(edges)}
    a = jt.Topology.from_edges(4, edges, weights=w)
    b = pt.Topology.from_edges(4, edges, weights=w)
    np.testing.assert_array_equal(b.weights, a.weights)
    _assert_same_schedule(jt.build_schedule(a), pt.build_schedule(b))


@pytest.mark.parametrize("bad", [
    np.ones((2, 3)) / 3,                       # not square
    np.array([[1.5, -0.5], [0.5, 0.5]]),       # negative weight
    np.array([[0.5, 0.4], [0.5, 0.5]]),        # row does not sum to 1
])
def test_invalid_weights_raise_like_the_reference(bad):
    with pytest.raises(ValueError):
        jt.Topology(weights=bad)
    with pytest.raises(ValueError):
        pt.Topology(weights=bad)


def test_equivalence_and_identity_hash():
    a, b = pt.RingGraph(6), pt.RingGraph(6)
    assert a != b and hash(a) != hash(b)  # identity equality, as the reference
    assert pt.IsTopologyEquivalent(a, b)
    assert not pt.IsTopologyEquivalent(a, pt.ExponentialTwoGraph(6))
    assert not pt.IsTopologyEquivalent(a, None)
    assert (pt.IsTopologyEquivalent(a, pt.RingGraph(5))
            == jt.IsTopologyEquivalent(jt.RingGraph(6), jt.RingGraph(5)))
