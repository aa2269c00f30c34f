"""Gossip of meshes over the window table (``bluefog_tpu_torch/sharding/
gossip.py``) and ``topology.heal``, against the JAX package's
(``bluefog_tpu/sharding/gossip.py``, ``bluefog_tpu/topology/graphs.py``):

- ``heal`` gives the JAX package's weights and inactive set for Ring,
  Exp-2 and the star with one and two dead ranks, and composes as there;
- ``run_sharded_gossip`` is bit-equal to the JAX package's on the same
  seeded trees at ``axes={}``, ``{tp: 2}`` and ``{fsdp: 2, tp: 2}``, with
  and without ``heal_after``/``dead_ranks``, and holds the JAX package's
  own checks (``tests/test_sharding.py``): the shard-local run equals the
  gathered one, and each coordinate's mass audit is exact, through a heal
  too.
"""

import os
import uuid

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from bluefog_tpu import topology as jtopo
from bluefog_tpu.sharding.gossip import run_sharded_gossip as j_run
from bluefog_tpu.sharding.rules import RuleTable as JRuleTable
from jax.sharding import PartitionSpec as JP

from bluefog_tpu_torch import topology as ptopo
from bluefog_tpu_torch.sharding import PartitionSpec as PP
from bluefog_tpu_torch.sharding import RuleTable, inner_coords
from bluefog_tpu_torch.sharding.gossip import run_sharded_gossip


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread: this file's work is host numpy."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _name(tag):
    return f"{tag}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


GRAPHS = {"ring": ("RingGraph", {}), "exp2": ("ExponentialTwoGraph", {}),
          "star": ("StarGraph", {})}


def _graphs(kind, n):
    fn, kw = GRAPHS[kind]
    return getattr(jtopo, fn)(n, **kw), getattr(ptopo, fn)(n, **kw)


@pytest.mark.parametrize("dead", [[3], [2, 5]], ids=["one", "two"])
@pytest.mark.parametrize("kind", list(GRAPHS))
def test_heal_matches_the_jax_package(kind, dead):
    jt, pt = _graphs(kind, 8)
    want, got = jtopo.heal(jt, dead), ptopo.heal(pt, dead)
    assert got.weights.tobytes() == want.weights.tobytes()
    assert got.inactive == want.inactive == frozenset(dead)
    assert got.name.endswith(f"+heal({sorted(dead)})")
    assert np.allclose(got.weights.sum(axis=1), 1.0)
    for r in dead:
        assert got.out_neighbors(r) == [] and got.in_neighbors(r) == []
    assert ptopo.heal(pt, []) is pt


@pytest.mark.parametrize("kind", list(GRAPHS))
def test_heal_composes_as_in_the_jax_package(kind):
    jt, pt = _graphs(kind, 8)
    a, b = [1], [4, 6]
    got = ptopo.heal(ptopo.heal(pt, a), b)
    assert got.weights.tobytes() == ptopo.heal(pt, a + b).weights.tobytes()
    assert got.weights.tobytes() == jtopo.heal(jtopo.heal(jt, a),
                                               b).weights.tobytes()
    assert got.inactive == frozenset(a + b)
    assert got.name.count("+heal(") == 1  # one collapsed suffix
    with pytest.raises(ValueError, match="every rank dead"):
        ptopo.heal(pt, range(8))
    with pytest.raises(ValueError, match="out of range"):
        ptopo.heal(pt, [8])


def _params():
    """The tree of ``tests/test_sharding.py``."""
    rng = np.random.default_rng(7)
    return {
        "emb": {"kernel": rng.standard_normal((8, 4))},
        "blk": {
            "up": {"kernel": rng.standard_normal((4, 8)),
                   "bias": rng.standard_normal((8,))},
            "down": {"kernel": rng.standard_normal((8, 4))},
            "ln": {"scale": np.ones((4,)), "count": np.zeros(())},
        },
    }


def _rank_params(n):
    rng = np.random.default_rng(11)
    base = _params()

    def noisy(t):
        return {k: noisy(v) if isinstance(v, dict)
                else np.asarray(v) + rng.standard_normal(np.shape(v))
                for k, v in t.items()}

    return [noisy(base) for _ in range(n)]


def _tables(axes):
    rules = [(r"up/kernel$", (None, "tp")), (r"down/kernel$", ("tp", None)),
             (r"emb/kernel$", ("fsdp", None))]

    def table(P, T):
        keep = [(pat, P(*spec)) for pat, spec in rules
                if all(a is None or a in axes for a in spec)]
        return T(keep + [(".*", P())], axes=axes)

    return table(JP, JRuleTable), table(PP, RuleTable)


def _flat(tree):
    """Leaves by '/'-joined name (the two packages order dicts apart)."""
    out = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                out["/".join(pre + (k,))] = np.asarray(v)

    walk(tree, ())
    return out


AXES = [{}, {"tp": 2}, {"fsdp": 2, "tp": 2}]


@pytest.mark.parametrize("healed", [False, True], ids=["plain", "heal"])
@pytest.mark.parametrize("axes", AXES, ids=["gathered", "tp2", "fsdp2_tp2"])
@pytest.mark.parametrize("kind", ["ring", "exp2"])
def test_run_sharded_gossip_is_bit_equal_to_the_jax_packages(kind, axes,
                                                             healed):
    jt, pt = _graphs(kind, 4)
    p0 = _rank_params(4)
    jtable, ptable = _tables(axes)
    kw = (dict(rounds=8, heal_after=3, dead_ranks=[2]) if healed
          else dict(rounds=6))
    want = j_run(jt, p0, jtable, axes, name=_name("jsg"), **kw)
    got = run_sharded_gossip(pt, p0, ptable, axes, name=_name("sg"), **kw)
    assert got.dead_ranks == want.dead_ranks == ([2] if healed else [])
    assert got.deposits == want.deposits
    assert (got.shard_bytes_per_deposit, got.saved_bytes_per_deposit) == (
        want.shard_bytes_per_deposit, want.saved_bytes_per_deposit)
    assert set(got.total_mass) == {
        tuple(c[a] for a in axes) for c in inner_coords(axes)}
    for key, mass in got.total_mass.items():
        assert mass == want.total_mass[key]
        assert abs(mass - 4.0) < 1e-9  # per coordinate, deaths included
    for r in range(4):
        if healed and r == 2:
            assert got.params[r] is None
            continue
        g, w = _flat(got.params[r]), _flat(want.params[r])
        assert set(g) == set(w)
        for name in g:
            assert g[name].dtype == w[name].dtype, name
            assert g[name].tobytes() == w[name].tobytes(), (r, name)


@pytest.mark.parametrize("healed", [False, True], ids=["plain", "heal"])
def test_shard_local_run_is_bit_equal_to_the_gathered_run(healed):
    """The JAX package's equivalence claim, held by the port alone: the
    shard-local gossip does each element's arithmetic in the same order
    as the gathered run, so the reassembled trees are bit-equal."""
    pt = ptopo.RingGraph(4)
    p0 = _rank_params(4)
    kw = (dict(rounds=8, heal_after=3, dead_ranks=[2]) if healed
          else dict(rounds=6))
    ref = run_sharded_gossip(pt, p0, _tables({})[1], {}, name=_name("g"),
                             **kw)
    axes = {"fsdp": 2, "tp": 2}
    shd = run_sharded_gossip(pt, p0, _tables(axes)[1], axes,
                             name=_name("s"), **kw)
    assert shd.saved_bytes_per_deposit > 0
    for a, b in zip(ref.params, shd.params):
        if a is None:
            assert b is None
            continue
        fa, fb = _flat(a), _flat(b)
        for name in fa:
            assert fa[name].tobytes() == fb[name].tobytes(), name


def test_sharded_gossip_on_tensors_and_its_errors():
    """Tensor trees take the same path (the packer carries them), and the
    Python twin of the table gives the same bits."""
    p0 = _rank_params(4)
    tp0 = [pytree.tree_map(torch.tensor, t) for t in p0]
    axes = {"tp": 2}
    table = _tables(axes)[1]
    a = run_sharded_gossip(ptopo.RingGraph(4), p0, table, axes,
                           name=_name("np"), rounds=3)
    b = run_sharded_gossip(ptopo.RingGraph(4), tp0, table, axes,
                           name=_name("tt"), rounds=3, native=False)
    for ra, rb in zip(a.params, b.params):
        fa, fb = _flat(ra), _flat(rb)
        for name in fa:
            assert fb[name].tobytes() == fa[name].tobytes(), name
    with pytest.raises(ValueError, match="param trees"):
        run_sharded_gossip(ptopo.RingGraph(4), p0[:3], table, axes)
    with pytest.raises(ValueError, match="heal_after"):
        run_sharded_gossip(ptopo.RingGraph(4), p0, table, axes,
                           dead_ranks=[1])
