"""K3's twins and the port's local attention against the JAX package.

The port runs on the CPU, where K3's three wrappers take their plain twins;
the CUDA kernels themselves are held against the same twins on the card by
``chip_smoke.py``.  Two oracles:

- the library kernel the JAX model takes on a TPU,
  ``jax.experimental.pallas.ops.tpu.flash_attention``, run here under
  ``pltpu.force_tpu_interpret_mode()`` with the tiles ``_flash_block_sizes``
  gives it: its ``(o, l, m)`` residuals and the gradients of ``sum(o * w)``
  (its custom VJP's forward and backward rules, jitted, one forward for
  both), against the twins' ``(o, l, m)`` and the gradients through the
  port's ``FlashAttention`` autograd function, at (B, H, T, D) = (1, 2, 256,
  64), and its ``di`` formula against the dQ twin's ``di``;
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


@pytest.fixture(scope="module")
def _warm_interpreter():
    """One small library call in interpret mode and one through the port's
    autograd function, so that the one-time start-up of JAX's CPU compiler,
    the Pallas interpreter and torch's CPU kernels is paid once per module
    and not by whichever interpret-mode case runs first."""
    t = 128
    x = jnp.zeros((1, 1, t, 64), jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        jax.block_until_ready(jax.jit(_library_vjp, static_argnums=(4, 5, 6))(
            x, x, x, x, True, 1.0, jra._flash_block_sizes(t)))
    y = torch.zeros(1, 1, t, 64, requires_grad=True)
    torch.autograd.grad(fk.flash_attention(y, y, y, causal=True), (y,),
                        torch.ones(1, 1, t, 64))


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


def _library_vjp(q, k, v, w, causal, scale, blocks):
    """The library's ``(o, l, m)`` and the gradients of ``sum(o * w)``: its
    custom VJP's forward rule (which keeps ``o``, ``l`` and ``m`` as
    residuals) and backward rule, as ``jax.vjp`` of ``flash_attention``
    runs them, with one forward for both."""
    o, res = lib_fa._flash_attention_fwd(q, k, v, None, None, False, causal,
                                         scale, blocks, False)
    dq, dk, dv = lib_fa._flash_attention_bwd(False, causal, scale, blocks,
                                             False, res, w)[:3]
    return o, res[-2], res[-1], dq, dk, dv


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twins_match_the_library_kernel_in_interpret_mode(dtype, causal,
                                                         _warm_interpreter):
    b, h, t, d = 1, 2, 256, 64
    scale = 1.0 / np.sqrt(d)
    q, k, v, w = _arrays((b, h, t, d), 4, seed=11 + causal)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jw = (jnp.asarray(a).astype(jdt) for a in (q, k, v, w))
    blocks = jra._flash_block_sizes(t)
    with pltpu.force_tpu_interpret_mode():
        # jitted: the interpreter's trace compiles once instead of running
        # op by op
        got_lib = jax.jit(_library_vjp, static_argnums=(4, 5, 6))(
            jq, jk, jv, jw, causal, scale, blocks)
    want = {n: np.asarray(x.astype(jnp.float32))
            for n, x in zip(("o", "l", "m", "dq", "dk", "dv"), got_lib)}

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
    q, k, v, do = (torch.randn(1, 2, 128, 32) for _ in range(4))
    def counts():
        return (fk.flash_forward.launches, fk.flash_backward_dkv.launches,
                fk.flash_backward_dq.launches, fk.flash_backward_dkv.copies,
                fk.flash_backward_dq.copies)

    before = counts()
    o, l, m = fk.flash_forward(q, k, v, causal=True, scale=0.5)
    dq, di = fk.flash_backward_dq(q, k, v, do, l, m, o, causal=True,
                                  scale=0.5)
    dk, dv = fk.flash_backward_dkv(q, k, v, do, l, m, di, causal=True,
                                   scale=0.5)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert di.shape == l.shape and di.dtype == torch.float32
    assert counts() == before
    with pytest.raises(ValueError, match="shape"):
        fk.flash_forward(q, k[:, :, :64], v, causal=True, scale=0.5)
    with pytest.raises(TypeError):
        fk.flash_forward(q, k.double(), v, causal=True, scale=0.5)
    with pytest.raises(ValueError, match="float32"):
        fk.flash_backward_dq(q, k, v, do, l.double(), m, o, causal=True,
                             scale=0.5)
    with pytest.raises(ValueError, match="float32"):
        fk.flash_backward_dkv(q, k, v, do, l, m, di[..., :64], causal=True,
                              scale=0.5)
    # dQ takes the forward's o, of q's shape and dtype
    with pytest.raises(ValueError, match="shape"):
        fk.flash_backward_dq(q, k, v, do, l, m, o[:, :, :64], causal=True,
                             scale=0.5)
    with pytest.raises(TypeError):
        fk.flash_backward_dq(q, k, v, do, l, m, o.double(), causal=True,
                             scale=0.5)
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fk.flash_forward(*meta, causal=True, scale=0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dq_twin_returns_the_library_di(dtype):
    """The dQ twin's ``di`` is ``sum(o * do, -1)`` in f32: the same as
    torch's sum and as the library's formula (``flash_attention.py``'s VJP
    rule) on the same values."""
    b, h, t, d = 2, 3, 128, 64
    q, k, v, do = _arrays((b, h, t, d), 4, seed=21)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo = (_to_torch(a, tdt) for a in (q, k, v, do))
    o, l, m = fk.flash_forward(tq, tk, tv, causal=True, scale=0.125)
    dq, di = fk.flash_backward_dq(tq, tk, tv, tdo, l, m, o, causal=True,
                                  scale=0.125)
    assert di.dtype == torch.float32 and di.shape == (b, h, t)
    assert dq.dtype == tdt
    ref = (o.float() * tdo.float()).sum(-1)
    assert _rel_err(_np(di), _np(ref)) <= RESIDUAL_TOL
    jo = jnp.asarray(_np(o)).astype(getattr(jnp, dtype))
    jdo = jnp.asarray(do).astype(getattr(jnp, dtype))
    lib = jnp.sum(jo.astype(jnp.float32) * jdo.astype(jnp.float32), axis=-1)
    assert _rel_err(_np(di), np.asarray(lib)) <= RESIDUAL_TOL


def test_backward_runs_dq_first_and_hands_its_di_to_dkv(monkeypatch):
    calls = []
    dq_fn, dkv_fn = fk.flash_backward_dq, fk.flash_backward_dkv

    def dq(*args, **kw):
        out = dq_fn(*args, **kw)
        calls.append(("dq", out[1]))
        return out

    def dkv(q, k, v, do, l, m, di, **kw):
        calls.append(("dkv", di))
        return dkv_fn(q, k, v, do, l, m, di, **kw)

    monkeypatch.setattr(fk, "flash_backward_dq", dq)
    monkeypatch.setattr(fk, "flash_backward_dkv", dkv)
    q, k, v, w = (_to_torch(a, torch.float32).requires_grad_()
                  for a in _arrays((1, 2, 128, 32), 4, seed=8))
    out = fk.flash_attention(q, k, v, causal=True, sm_scale=0.25)
    torch.autograd.grad(out, (q, k, v), w.detach())
    assert [name for name, _ in calls] == ["dq", "dkv"]
    assert calls[1][1] is calls[0][1]


def test_backward_copies_only_views_that_refuse_16_byte_loads():
    """The bf16 backward kernels' alignment gate, which runs before a
    launch: the model's q, k and v (views of one (B, T, 3 H D) projection)
    and a (B, T, H, D) gradient pass as they are; a view with a token
    stride that is no multiple of 8 elements, or at an odd offset, is
    copied to fresh memory and counted; f32 passes untouched."""
    b, t, h, d = 2, 64, 3, 32
    qkv = torch.randn(b, t, 3 * h * d).to(torch.bfloat16)
    views = [x.unflatten(-1, (h, d)).transpose(1, 2)
             for x in qkv.split(h * d, dim=-1)]
    grad = torch.randn(b, t, h, d).to(torch.bfloat16).transpose(1, 2)
    counter = type("Wrapper", (), {"copies": 0})
    got = fk._aligned(counter, views + [grad])
    assert all(x is y for x, y in zip(got, views + [grad]))
    assert counter.copies == 0
    wide = torch.randn(b, t, h * d + 4).to(torch.bfloat16)
    odd_stride = wide[..., :h * d].unflatten(-1, (h, d)).transpose(1, 2)
    flat = torch.randn(b * t * h * d + 1).to(torch.bfloat16)
    odd_offset = flat[1:].view(b, t, h, d).transpose(1, 2)
    assert fk._vec16(flat[:-1].view(b, t, h, d).transpose(1, 2))
    got = fk._aligned(counter, [views[0], odd_stride, odd_offset])
    assert got[0] is views[0] and counter.copies == 2
    for x, y in zip(got[1:], (odd_stride, odd_offset)):
        assert x is not y and torch.equal(x, y) and fk._vec16(x)
    f32 = [x.float() for x in (odd_stride, odd_offset)]
    assert fk._aligned(counter, f32) == f32 and counter.copies == 2
