"""The ported decentralized-optimization example against the JAX example.

``examples/decentralized_optimization.py`` builds one ``shard_map`` body per
algorithm; here each runs on the 8-device CPU mesh and the port's function
runs on rank-stacked CPU tensors, on the same least-squares data (the port's
``make_problem``, seeded numpy) for 50 steps.  Both compute in f32 with the
same operations in the same order, apart from the matrix products' summation
order, so they agree to rtol 1e-5.  A JAX window handed to the port mid-run
through ``convert.window_from_numpy`` must continue as the JAX run does.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import bluefog_tpu as bf
import bluefog_tpu.topology as jt
from bluefog_tpu.ops import windows as JW
from bluefog_tpu.parallel.api import shard_map
import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch import convert
from bluefog_tpu_torch.examples import decentralized_optimization as pdo
from bluefog_tpu_torch.ops import windows as PW

N, STEPS, RTOL = 8, 50, 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_decentralized_optimization",
        REPO / "examples" / "decentralized_optimization.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smap(body, n_in, n_out=1):
    bf.init()
    ctx = bf.get_context()
    return jax.jit(shard_map(
        body, mesh=ctx.mesh, in_specs=(P("bf"),) * n_in,
        out_specs=P("bf") if n_out == 1 else (P("bf"),) * n_out,
        check_vma=False))


@pytest.mark.parametrize("algorithm", sorted(pdo.ALGORITHMS))
def test_example_bodies_match_the_jax_example(algorithm):
    jex = _jax_example()
    A, b, x_star = pdo.make_problem(N)
    _, _, lr, _ = pdo.ALGORITHMS[algorithm]
    assert jex.ALGORITHMS[algorithm][2] == lr and jex.DIM == pdo.DIM
    want = np.asarray(_smap(getattr(jex, algorithm)(
        N, A, b, STEPS, lr), 2)(jnp.asarray(A), jnp.asarray(b)))
    got = getattr(pdo, algorithm)(torch.from_numpy(A), torch.from_numpy(b),
                                  STEPS, lr).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # 50 steps move every algorithm toward the optimum
    assert np.abs(got - x_star).max() < np.abs(x_star).max()


def test_window_handed_over_mid_run_continues_as_in_jax():
    """Push-sum: 25 JAX steps, the window's arrays handed to the port, 25
    port steps, against 50 JAX steps of the example's own body."""
    jex = _jax_example()
    A, b, _ = pdo.make_problem(N)
    _, _, lr, _ = pdo.ALGORITHMS["push_sum"]
    half = STEPS // 2
    jsched = jt.build_schedule(jt.RingGraph(N, connect_style=1))

    def first_half(A_blk, b_blk):
        # the example's push-sum step, stopped half way with its window
        Ar, br = A_blk[0], b_blk[0]
        win = JW.win_create(jnp.zeros((pdo.DIM,)), jsched, "bf",
                            associated_p=True)

        def step(win, t):
            x, p = win.self_buf, JW.win_associated_p(win)
            z = x / jnp.maximum(p, 1e-12)
            lr_t = lr / jnp.sqrt(1.0 + t / 100.0)
            x = x - lr_t * jex.grad(Ar, br, z) * p
            win = JW.win_sync(win, x)
            win = JW.win_accumulate(win, None, "bf", dst_weight=0.5)
            win = win.replace(self_buf=0.5 * win.self_buf,
                              assoc_self=0.5 * win.assoc_self)
            _, win = JW.win_update_then_collect(win, "bf")
            return win, None

        win, _ = jax.lax.scan(step, win, jnp.arange(half))
        return (win.self_buf[None], win.peer_bufs[None],
                win.assoc_self[None], win.assoc_peers[None])

    jA, jb = jnp.asarray(A), jnp.asarray(b)
    mid = [np.asarray(t) for t in _smap(first_half, 2, 4)(jA, jb)]
    want = np.asarray(_smap(jex.push_sum(N, A, b, STEPS, lr), 2)(jA, jb))

    win = convert.window_from_numpy(
        *mid, schedule=pt.build_schedule(pt.RingGraph(N, connect_style=1)),
        device="cpu")
    np.testing.assert_array_equal(win.self_buf.numpy(), mid[0])
    np.testing.assert_array_equal(win.peer_bufs.numpy(), mid[1])
    np.testing.assert_array_equal(win.assoc_self.numpy(), mid[2])
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)
    for t in range(half, STEPS):
        pdo.push_sum_step(win, tA, tb, t, lr)
    got = (win.self_buf / PW.win_associated_p(win)[:, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    assert float(win.assoc_self.sum()) == N  # p's mass, exactly


def test_window_from_numpy_carries_a_pytree_window_with_bf16():
    """A JAX window over an f32 and a bf16 leaf, after a put, handed to the
    port: the same buffers, and the next put and update agree."""
    jsched = jt.build_schedule(jt.ExponentialTwoGraph(N))
    psched = pt.build_schedule(pt.ExponentialTwoGraph(N))
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((N, 3)).astype(np.float32),
            "h": rng.standard_normal((N, 2, 2)).astype(np.float32)}
    jtree = {"a": jnp.asarray(tree["a"]),
             "h": jnp.asarray(tree["h"]).astype(jnp.bfloat16)}

    def body(t):
        t = jax.tree_util.tree_map(lambda v: v[0], t)
        st = JW.win_create(t, jsched, "bf")
        st = JW.win_put(st, t, "bf", dst_weight=0.5)
        mid = (st.self_buf, st.peer_bufs)
        st = JW.win_put(st, t, "bf")
        out, _ = JW.win_update(st, "bf")
        return jax.tree_util.tree_map(lambda v: v[None], (mid, out))

    (self_buf, peer_bufs), out = _smap(body, 1)(jtree)
    win = convert.window_from_numpy(
        jax.tree_util.tree_map(np.asarray, self_buf),
        jax.tree_util.tree_map(np.asarray, peer_bufs), schedule=psched,
        device="cpu")
    assert win.bufs[torch.bfloat16].shape == (N, 4)
    assert win.peer_bufs["h"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        win.peer_bufs["h"].float().numpy(),
        np.asarray(peer_bufs["h"].astype(jnp.float32)))
    PW.win_put(win, None)
    got, _ = PW.win_update(win)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(out["a"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["h"].float().numpy(),
                               np.asarray(out["h"].astype(jnp.float32)),
                               rtol=2.0 ** -7)
    with pytest.raises(ValueError, match="peer_bufs"):
        convert.window_from_numpy(tree, {"a": np.zeros((N, 3, 3))},
                                  schedule=psched, device="cpu")


def test_example_cli_runs_on_the_cpu_and_needs_a_device_otherwise():
    xs = pdo.main(["--algorithm", "exact_diffusion", "--steps", "800",
                   "--device", "cpu"])
    assert xs.shape == (N, pdo.DIM)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pdo.main(["--algorithm", "push_sum", "--steps", "2"])
