"""K3's twins and the port's local attention against the JAX package.

The port runs on the CPU, where K3's three wrappers take their plain twins;
the CUDA kernels themselves are held against the same twins on the card by
``chip_smoke.py``.  Two oracles:

- the library kernel the JAX model takes on a TPU,
  ``jax.experimental.pallas.ops.tpu.flash_attention``, run here under
  ``pltpu.force_tpu_interpret_mode()`` with the tiles ``_flash_block_sizes``
  gives it: its ``(o, l, m)`` residuals and the gradients of ``sum(o * w)``,
  against the twins' ``(o, l, m)`` and the gradients through the port's
  ``FlashAttention`` autograd function, at (B, H, T, D) = (1, 2, 256, 64);
- the JAX ``local_attention(backend="dense")``, against the port's
  ``local_attention`` on eligible and ineligible calls.

Inputs are made with numpy from a seed.  Tolerances, as max |diff| over the
reference's largest magnitude: f32 1e-5 (f32 sums of at most 256 terms in
another order); bf16 2^-7 for o and 2^-6 for the gradients (a sum rounded to
bf16 may land one bf16 step, 2^-8 relative, from the library's), and 1e-5
for l and m in both, which the twins compute in f32 from the same products.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as lib_fa

from bluefog_tpu_torch.ops import flash_kernel as fk
from bluefog_tpu_torch.ops import ring_attention as pra

# the module: ``bluefog_tpu.ops`` exports a function of the same name
jra = importlib.import_module("bluefog_tpu.ops.ring_attention")

F32_TOL = 1e-5
BF16_O_TOL, BF16_GRAD_TOL = 2.0 ** -7, 2.0 ** -6
RESIDUAL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """Two torch threads, as in ``test_torch_slice.py``: the same sums on
    every machine, and no oversubscription of the test workers' cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _np(t):
    return t.detach().float().numpy().astype(np.float64)


def _rel_err(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twins_match_the_library_kernel_in_interpret_mode(dtype, causal):
    b, h, t, d = 1, 2, 256, 64
    scale = 1.0 / np.sqrt(d)
    q, k, v, w = _arrays((b, h, t, d), 4, seed=11 + causal)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jw = (jnp.asarray(a).astype(jdt) for a in (q, k, v, w))
    blocks = jra._flash_block_sizes(t)
    with pltpu.force_tpu_interpret_mode():
        o, l, m = lib_fa._flash_attention(jq, jk, jv, None, None, True,
                                          causal, scale, blocks, False)
        _, vjp = jax.vjp(lambda *x: lib_fa.flash_attention(
            *x, causal=causal, sm_scale=scale, block_sizes=blocks),
            jq, jk, jv)
        grads = vjp(jw)
    want = {"o": o, "l": l, "m": m, "dq": grads[0], "dk": grads[1],
            "dv": grads[2]}
    want = {n: np.asarray(x.astype(jnp.float32)) for n, x in want.items()}

    launches = (fk.flash_forward.launches, fk.flash_backward_dkv.launches,
                fk.flash_backward_dq.launches)
    tq, tk, tv = (_to_torch(a, tdt).requires_grad_() for a in (q, k, v))
    po, pl, pm = fk.flash_forward(tq.detach(), tk.detach(), tv.detach(),
                                  causal=causal, scale=scale)
    out = fk.flash_attention(tq, tk, tv, causal=causal, sm_scale=scale)
    pdq, pdk, pdv = torch.autograd.grad(out, (tq, tk, tv),
                                        _to_torch(w, tdt))
    # the autograd function's output is the forward wrapper's, computed anew
    # (f32 CPU matmuls need not repeat bit for bit)
    got = {"o": po, "o_autograd": out, "l": pl, "m": pm, "dq": pdq,
           "dk": pdk, "dv": pdv}
    want["o_autograd"] = want["o"]
    assert po.dtype == pdq.dtype == tdt and pl.dtype == torch.float32
    assert pl.shape == pm.shape == (b, h, t)
    for name, x in got.items():
        if name in ("l", "m"):
            tol = RESIDUAL_TOL
        elif dtype == "float32":
            tol = F32_TOL
        else:
            tol = BF16_O_TOL if name.startswith("o") else BF16_GRAD_TOL
        err = _rel_err(_np(x), want[name])
        assert err <= tol, (name, err, tol)
    # the twins count no launch: only a kernel launch does
    assert (fk.flash_forward.launches, fk.flash_backward_dkv.launches,
            fk.flash_backward_dq.launches) == launches


def _jax_fwd_and_grads(fn, q, k, v, w):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _port_fwd_and_grads(fn, q, k, v, w):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(w))
    return [_np(out)] + [_np(g) for g in grads]


@pytest.mark.parametrize("causal,tq,tk,d,q_off,k_off,backend", [
    (True, 256, 256, 64, 0, 0, "auto"),       # eligible: K3's twins
    (False, 128, 128, 32, 0, 0, "flash"),     # eligible, forced
    (True, 128, 128, 64, 0, 0, "dense"),      # eligible, dense asked for
    (True, 128, 256, 64, 128, 0, "auto"),     # shifted causal block
    (False, 96, 96, 64, 0, 0, "auto"),        # T not a multiple of 128
    (True, 128, 128, 16, 0, 0, "auto"),       # D < 32
], ids=["flash-causal", "flash-forced", "dense-asked", "shifted",
        "ragged-T", "small-D"])
def test_local_attention_matches_jax_dense(causal, tq, tk, d, q_off, k_off,
                                           backend):
    b, h = 2, 2
    q, w = _arrays((b, tq, h, d), 2, seed=3)
    k, v = _arrays((b, tk, h, d), 2, seed=4)
    want = _jax_fwd_and_grads(
        lambda *x: jra.local_attention(*x, causal=causal, q_offset=q_off,
                                       k_offset=k_off, backend="dense"),
        q, k, v, w)
    got = _port_fwd_and_grads(
        lambda *x: pra.local_attention(*x, causal=causal, q_offset=q_off,
                                       k_offset=k_off, backend=backend),
        q, k, v, w)
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel_err(g, r) <= F32_TOL, name


def test_tensor_offsets_take_the_dense_path(monkeypatch):
    """A tensor offset is the port's traced offset: never K3, as in JAX."""
    def no_flash(*a, **kw):
        raise AssertionError("K3 must not run on a tensor offset")

    monkeypatch.setattr(pra, "flash_attention", no_flash)
    q, k, v, w = _arrays((1, 128, 2, 32), 4, seed=5)
    off = torch.tensor(0)
    got = _port_fwd_and_grads(
        lambda *x: pra.local_attention(*x, causal=True, q_offset=off,
                                       k_offset=off, backend="auto"),
        q, k, v, w)
    want = _jax_fwd_and_grads(
        lambda *x: jra.local_attention(*x, causal=True, backend="dense"),
        q, k, v, w)
    for g, r in zip(got, want):
        assert _rel_err(g, r) <= F32_TOL


@pytest.mark.parametrize("tq,tk,d,causal,q_off,k_off", [
    (256, 256, 64, True, 0, 0),
    (256, 256, 64, False, 0, 128),
    (256, 256, 64, True, 0, 128),     # shifted causal
    (96, 96, 64, False, 0, 0),        # T % 128
    (64, 64, 64, False, 0, 0),        # T < 128
    (256, 128, 64, False, 0, 0),      # Tq != Tk
    (128, 128, 16, True, 0, 0),       # D < 32
    (384, 384, 32, True, 7, 7),       # equal static offsets
])
def test_eligibility_gate_matches_jax(monkeypatch, tq, tk, d, causal, q_off,
                                      k_off):
    """The port's gate is JAX's without the TPU-backend clause: with the
    backend reported as a TPU, the two agree on every case of
    ``tests/test_flash_attention.py:60-77`` and more."""
    monkeypatch.setattr(jra.jax, "default_backend", lambda: "tpu")
    jq, jk = jnp.zeros((1, tq, 2, d)), jnp.zeros((1, tk, 2, d))
    tq_, tk_ = torch.zeros(1, tq, 2, d), torch.zeros(1, tk, 2, d)
    assert (pra._flash_eligible(tq_, tk_, causal, q_off, k_off)
            == jra._flash_eligible(jq, jk, causal, q_off, k_off))
    # a tensor offset, the traced one, is never eligible
    assert not pra._flash_eligible(tq_, tk_, causal, torch.tensor(q_off),
                                   k_off)


def test_forced_flash_on_ineligible_raises():
    q = k = v = torch.zeros(1, 256, 2, 64)
    with pytest.raises(ValueError, match="flash"):
        # shifted causal offsets are never flash-eligible
        pra.local_attention(q, k, v, causal=True, q_offset=0, k_offset=128,
                            backend="flash")
    with pytest.raises(ValueError, match="flash"):
        pra.local_attention(q[:, :96], k[:, :96], v[:, :96], backend="flash")
    with pytest.raises(ValueError, match="backend"):
        pra.local_attention(q, k, v, backend="pallas")


def test_wrappers_check_and_count_only_card_launches():
    q, k, v = (torch.randn(1, 2, 128, 32) for _ in range(3))
    before = (fk.flash_forward.launches, fk.flash_backward_dkv.launches,
              fk.flash_backward_dq.launches)
    o, l, m = fk.flash_forward(q, k, v, causal=True, scale=0.5)
    di = (o * o).sum(-1)
    fk.flash_backward_dkv(q, k, v, o, l, m, di, causal=True, scale=0.5)
    fk.flash_backward_dq(q, k, v, o, l, m, di, causal=True, scale=0.5)
    assert (fk.flash_forward.launches, fk.flash_backward_dkv.launches,
            fk.flash_backward_dq.launches) == before
    with pytest.raises(ValueError, match="shape"):
        fk.flash_forward(q, k[:, :, :64], v, causal=True, scale=0.5)
    with pytest.raises(TypeError):
        fk.flash_forward(q, k.double(), v, causal=True, scale=0.5)
    with pytest.raises(ValueError, match="float32"):
        fk.flash_backward_dq(q, k, v, o, l.double(), m, di, causal=True,
                             scale=0.5)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fk.flash_forward(*meta, causal=True, scale=0.5)
