"""The port's sequence parallelism against the JAX package's.

``ring_attention`` (contiguous and zigzag, causal and full), the zigzag
layout helpers and ``all_to_all_attention`` (Ulysses) on the same seeded
inputs: the JAX functions under ``shard_map`` on the conftest's CPU mesh,
the port's over virtual ranks (the sequence-parallel axis leading).  f32,
with the reference tests' tolerances: outputs within 1e-5 and gradients
within 5e-5, absolute.  One Ulysses case (D = 32, T = 128) takes the port's
K3 route through its twins, where the JAX package's CPU run takes its dense
path.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from bluefog_tpu.parallel.api import shard_map
from bluefog_tpu_torch.ops import ring_attention as pra
from bluefog_tpu_torch.parallel.axes import Axis

jra = importlib.import_module("bluefog_tpu.ops.ring_attention")

OUT_TOL, GRAD_TOL = 1e-5, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]  # q, k, v and the output cotangent


def _jax_run(fn, n, q, k, v, cot):
    """``fn`` under shard_map over ``n`` devices, sequence-sharded; its
    output and the gradients of ``sum(out * cot)``."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    f = shard_map(fn, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                  out_specs=P(None, "sp"), check_vma=False)
    out, vjp = jax.vjp(jax.jit(f), *map(jnp.asarray, (q, k, v)))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(cot)))]


def _shard(x, n):
    """Global ``(B, T, H, D)`` -> rank-stacked ``(n, B, T / n, H, D)``."""
    return torch.from_numpy(np.array(x)).unflatten(1, (n, -1)).movedim(1, 0)


def _unshard(x):
    return x.movedim(0, 1).flatten(1, 2)


def _port_run(fn, n, q, k, v, cot):
    ins = [_shard(a, n).requires_grad_() for a in (q, k, v)]
    out = fn(*ins)
    grads = torch.autograd.grad(out, ins, _shard(cot, n))
    return [_unshard(a).detach().numpy() for a in (out, *grads)]


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=OUT_TOL)
    for g, w, name in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_attention_matches_jax(layout, causal):
    n, kv_tile = 4, 8          # two key tiles a block: the tiled fold runs
    q, k, v, cot = _inputs(0, 2, n * 16, 4, 8)
    if layout == "zigzag":
        q, k, v, cot = (np.asarray(jra.zigzag_shard(jnp.asarray(a), n))
                        for a in (q, k, v, cot))
    want = _jax_run(functools.partial(
        jra.ring_attention, axis_name="sp", causal=causal, layout=layout,
        kv_tile=kv_tile), n, q, k, v, cot)
    got = _port_run(functools.partial(
        pra.ring_attention, axis=Axis("sp", n), causal=causal,
        layout=layout, kv_tile=kv_tile), n, q, k, v, cot)
    _assert_close(got, want)
    if causal:   # and both are full causal attention over the global rows
        dense = np.asarray(jra.local_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True))
        if layout == "zigzag":
            dense = np.asarray(jra.zigzag_shard(jra.local_attention(
                *(jra.zigzag_unshard(jnp.asarray(a), n) for a in (q, k, v)),
                causal=True), n))
        np.testing.assert_allclose(got[0], dense, rtol=0, atol=OUT_TOL)


def test_ring_attention_with_ranks_in_a_later_dimension():
    """The axis need not lead: a (2, n) group with the ring on dim 1 gives
    each row what a leading-axis call gives it."""
    n = 4
    q, k, v, _ = _inputs(1, 2, n * 8, 2, 8)
    stacked = [torch.stack([_shard(a, n), 2 * _shard(a, n)], 0)
               for a in (q, k, v)]
    got = pra.ring_attention(*stacked, Axis("sp", n, 1), causal=True)
    for i in range(2):
        want = pra.ring_attention(*(s[i] for s in stacked), Axis("sp", n),
                                  causal=True)
        torch.testing.assert_close(got[i], want, rtol=0, atol=0)


def test_zigzag_round_trip_and_layout_match_jax():
    n = 4
    x = np.random.default_rng(2).standard_normal((2, 8 * n, 3)).astype(
        np.float32)
    got = pra.zigzag_shard(torch.from_numpy(x), n)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jra.zigzag_shard(jnp.asarray(x), n)))
    back = pra.zigzag_unshard(got, n)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        pra._zigzag_permutation(n, 8 * n),
        jra._zigzag_permutation(n, 8 * n))
    with pytest.raises(ValueError, match="divisible"):
        pra.zigzag_shard(torch.from_numpy(x[:, :7]), n)


@pytest.mark.parametrize("case", ["causal", "full", "causal-k3"])
def test_all_to_all_attention_matches_jax(case, monkeypatch):
    causal = case != "full"
    if case == "causal-k3":   # T = 4 x 32 = 128, one head of D = 32 a rank
        n, shape = 4, (1, 128, 4, 32)
    else:
        n, shape = 4, (2, 32, 8, 8)
    q, k, v, cot = _inputs(3, *shape)
    calls = []
    real = pra.flash_attention
    monkeypatch.setattr(pra, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    want = _jax_run(functools.partial(
        jra.all_to_all_attention, axis_name="sp", causal=causal,
        backend="auto"), n, q, k, v, cot)
    got = _port_run(functools.partial(
        pra.all_to_all_attention, axis=Axis("sp", n), causal=causal,
        backend="auto"), n, q, k, v, cot)
    _assert_close(got, want)
    # one K3 call serves every rank of the group (the ranks fold into K3's
    # batch); the narrow case takes the dense path
    assert len(calls) == (1 if case == "causal-k3" else 0)
    x = torch.zeros(3, 1, 4, 8, 8)     # 8 heads over 3 ranks
    with pytest.raises(ValueError, match="divisible"):
        pra.all_to_all_attention(x, x, x, Axis("sp", 3))


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_causal_ring_folds_only_past_blocks(layout, monkeypatch):
    """The causal skip stays a skip: each step folds only the ranks whose
    arriving block is in their past, gathered into one batch."""
    n = 4
    q, k, v, _ = _inputs(4, 1, n * 8, 2, 8)
    if layout == "zigzag":
        q, k, v = (pra.zigzag_shard(torch.from_numpy(a), n).numpy()
                   for a in (q, k, v))
    rows = []
    real = pra._fold_block

    def spy(state, q, *a, **kw):
        rows.append((q.shape[0], kw["masked"]))
        return real(state, q, *a, **kw)

    monkeypatch.setattr(pra, "_fold_block", spy)
    pra.ring_attention(*(_shard(a, n) for a in (q, k, v)), Axis("sp", n),
                       causal=True, layout=layout)
    if layout == "contiguous":
        # step 0: every rank's masked diagonal; step s: ranks s .. n-1
        assert rows == [(n, True)] + [(n - s, False) for s in range(1, n)]
    else:
        # step 0: two diagonals and back x front; then back x front for
        # every rank, the front half for ranks >= s, the back for ranks < s
        want = [(n, True), (n, True), (n, False)]
        for s in range(1, n):
            want += [(n, False), (n - s, False), (s, False)]
        assert rows == want
        # two half-chunks a rank a step: balanced
        assert all(a + b == n for (a, _), (b, _) in
                   zip(want[4::3], want[5::3]))
