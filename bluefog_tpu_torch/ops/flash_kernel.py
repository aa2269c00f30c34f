"""K3: the library flash attention as three hand-written CUDA kernels, their
plain PyTorch twins, and the autograd function over them.

Counterpart of the Pallas TPU kernel that
``bluefog_tpu/ops/ring_attention.py::local_attention`` calls
(``jax.experimental.pallas.ops.tpu.flash_attention``), with the library's
split into three ``pallas_call``\\ s and its layout, ``(B, H, T, D)``:

- :func:`flash_forward` -> ``(o, l, m)`` (``_flash_attention_impl`` with
  ``save_residuals``): the output in the input dtype and, per query row, the
  f32 ``(B, H, T)`` sum ``l`` of ``exp(s - m)`` and maximum ``m`` of the
  scaled scores ``s``;
- :func:`flash_backward_dq` -> ``(dq, di)`` (``_flash_attention_bwd_dq``),
  which also computes ``di = sum(o * do, -1)`` in f32, the library's
  ``di`` (computed in XLA between its two backward kernels);
- :func:`flash_backward_dkv` -> ``(dk, dv)`` (``_flash_attention_bwd_dkv``),
  from that ``di``.

The CUDA sources are ``bluefog_tpu_torch/csrc/flash_attention.cu`` (the
forward, bf16 on wgmma, and the f32 backward) and
``csrc/flash_attention_bwd.cu`` (the bf16 backward on wgmma), with the
wgmma helpers both share in ``csrc/flash_wgmma.cuh``; their headers state
the bounds and the designs.  Each
wrapper takes any batch, head and token strides with ``D`` contiguous (the
model's q, k and v are views of its fused projection), writes its outputs
into ``(B, T, H, D)`` memory (so the model's transpose back is a view),
launches its kernel on a CUDA tensor (or raises) and adds one to its
``launches``; on a CPU tensor, and only there, it runs its ``*_plain`` twin,
which computes the same function as the library: f32 scores of the inputs,
``p = exp(s - m) / l``, ``p`` rounded to the input dtype before ``p v`` and
``p^T do``, ``ds = (do v^T - di) p s`` rounded likewise before ``ds^T q`` and
``ds k``.  On the card the twins are the kernels' oracle in
``chip_smoke.py``, never on the path.  The bf16 kernels read 16-byte
vectors: a wrapper copies a bf16 input whose batch, head or token stride is
not a multiple of 8 elements, or whose pointer is not 16-byte aligned, and
counts it in its ``copies`` (the model's views take none).

:class:`FlashAttention` is the ``torch.autograd.Function`` whose forward is
the forward wrapper and whose backward launches dQ (with ``di``) and then
dK/dV.  :func:`flash_attention` is the library's entry point.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

__all__ = [
    "BUILT",
    "HEAD_DIMS",
    "DTYPES",
    "flash_attention",
    "FlashAttention",
    "flash_forward",
    "flash_forward_plain",
    "flash_backward_dkv",
    "flash_backward_dkv_plain",
    "flash_backward_dq",
    "flash_backward_dq_plain",
]

# dtype -> (the kernels' dtype code, rows per tile: T must be a multiple)
DTYPES = {torch.float32: (0, 32), torch.bfloat16: (1, 64)}
# head dims the card takes: the bf16 kernels are instantiated for these; the
# f32 ones take any D up to 128
HEAD_DIMS = {torch.bfloat16: (32, 64, 96, 128),
             torch.float32: tuple(range(1, 129))}
BUILT = "bf16 with D in 32, 64, 96, 128; f32 with D up to 128"


# --- the plain twins ---------------------------------------------------------

def _scores(q, k, scale: float, causal: bool) -> torch.Tensor:
    """f32 ``(B, H, T, T)`` scaled scores ``q k^T scale`` (products of the
    inputs, summed in f32), ``-inf`` above the diagonal when causal."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t = q.shape[-2]
        above = torch.ones(t, t, dtype=torch.bool, device=s.device).triu_(1)
        s = s.masked_fill(above, float("-inf"))
    return s


def flash_forward_plain(q, k, v, *, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Twin of the forward kernel: ``(o, l, m)``, with ``m`` the row maximum
    of the scaled scores, ``l`` the row sum of ``exp(s - m)``, and ``o`` the
    normalised probabilities rounded to ``v``'s dtype times ``v``, summed in
    f32 and returned in ``q``'s dtype."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul((p / l[..., None]).to(v.dtype).float(), v.float())
    return o.to(q.dtype), l, m


def _probs(q, k, l, m, scale, causal) -> torch.Tensor:
    return torch.exp(_scores(q, k, scale, causal) - m[..., None]) * (
        1.0 / l)[..., None]


def _dscores(p, v, do, di, scale) -> torch.Tensor:
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return (dp - di[..., None]) * p * scale


def flash_backward_dkv_plain(q, k, v, do, l, m, di, *, causal: bool,
                             scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of the dK/dV kernel: ``p = exp(s - m) / l``, ``dv = p^T do`` and
    ``dk = ds^T q`` with ``ds = (do v^T - di) p scale``, ``p`` and ``ds``
    rounded to ``do``'s dtype first."""
    p = _probs(q, k, l, m, scale, causal)
    ds = _dscores(p, v, do, di, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(do.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_plain(q, k, v, do, l, m, o, *, causal: bool,
                            scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Twin of the dQ kernel: ``(dq, di)`` with ``di = sum(o * do, -1)`` in
    f32, as the library computes it, and ``dq = ds k``, ``ds`` rounded to
    ``k``'s dtype first."""
    di = (o.float() * do.float()).sum(dim=-1)
    ds = _dscores(_probs(q, k, l, m, scale, causal), v, do, di, scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype), di


# --- the kernels' wrappers ---------------------------------------------------

def _check(q, k, v, *others) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)) + others:
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, T, D), got shape "
                             f"{tuple(t.shape)}")
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}: K3 takes Tq == Tk and equal "
                             "heads")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_rows(q, *rows) -> None:
    b, h, t, _ = q.shape
    for name, r in rows:
        if (r.shape != (b, h, t) or r.dtype != torch.float32
                or r.device != q.device):
            raise ValueError(f"{name} must be float32 ({b}, {h}, {t}) on "
                             f"{q.device}, got {r.dtype} {tuple(r.shape)} on "
                             f"{r.device}")


def _on_card(q, name: str) -> bool:
    """False for a CPU tensor; for a CUDA tensor, True once its dtype, head
    dim and length are ones the kernels take (else raises); raises on any
    other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 on the card, got "
                        f"{q.dtype}")
    t, d = q.shape[2], q.shape[3]
    if d not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"{name}: head dim {d} is not built for {q.dtype} "
                         f"({BUILT})")
    tile = DTYPES[q.dtype][1]
    if t == 0 or t % tile:
        raise ValueError(f"{name}: T={t} must be a positive multiple of "
                         f"{tile} for {q.dtype}")
    return True


def _vec16(t: torch.Tensor) -> bool:
    """Whether a 16-bit tensor's rows allow 16-byte loads: batch, head and
    token strides a multiple of 8 elements, the pointer 16-byte aligned."""
    return (t.element_size() == 2 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _launch_args(inputs, outputs):
    """The kernels' host array of (batch, head, token) strides, inputs then
    outputs."""
    for t in inputs + outputs:
        if t.stride(-1) != 1:
            raise ValueError("K3 needs the head dim contiguous (stride 1), "
                             f"got strides {t.stride()}")
    strides = [s for t in inputs + outputs for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(strides))(*strides)


def _aligned(wrapper, inputs):
    """The bf16 kernels' inputs, each copied to fresh contiguous memory (and
    counted in ``wrapper.copies``) unless it allows 16-byte loads."""
    if inputs[0].dtype != torch.bfloat16:
        return inputs
    out = []
    for t in inputs:
        if t.stride(-1) == 1 and not _vec16(t):
            t = torch.empty(t.shape, dtype=t.dtype,
                            device=t.device).copy_(t)
            wrapper.copies += 1
        out.append(t)
    return out


def _btdh(like: torch.Tensor) -> torch.Tensor:
    """An empty ``(B, H, T, D)`` tensor over ``(B, T, H, D)`` memory."""
    b, h, t, d = like.shape
    return torch.empty(b, t, h, d, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_forward(q, k, v, *, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(o, l, m)`` (see :func:`flash_forward_plain`,
    which CPU tensors take)."""
    _check(q, k, v)
    if not _on_card(q, "flash_forward"):
        return flash_forward_plain(q, k, v, causal=causal, scale=scale)
    from bluefog_tpu_torch.ops import _build

    lib = _build.load()
    b, h, t, d = q.shape
    if scale < 0 and q.dtype == torch.bfloat16:
        # the bf16 kernel takes each row's maximum of the unscaled scores,
        # which holds for a scale that is not negative: (-q) k^T (-scale)
        q, scale = -q, -scale
    q, k, v = _aligned(flash_forward, [q, k, v])
    o = _btdh(q)
    l = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    strides = _launch_args([q, k, v], [o])
    with torch.cuda.device(q.device):
        err = lib.bf_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            l.data_ptr(), m.data_ptr(), strides, b, h, t, d, int(causal),
            float(scale), DTYPES[q.dtype][0], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_forward launch failed: cudaError {err}")
    flash_forward.launches += 1
    return o, l, m


def flash_backward_dkv(q, k, v, do, l, m, di, *, causal: bool, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: ``l`` and ``m`` from :func:`flash_forward`, ``di =
    sum(o * do, -1)`` in f32 from :func:`flash_backward_dq` (see
    :func:`flash_backward_dkv_plain`, which CPU tensors take)."""
    _check(q, k, v, ("do", do))
    _check_rows(q, ("l", l), ("m", m), ("di", di))
    if not _on_card(q, "flash_backward_dkv"):
        return flash_backward_dkv_plain(q, k, v, do, l, m, di, causal=causal,
                                        scale=scale)
    from bluefog_tpu_torch.ops import _build

    lib = _build.load()
    b, h, t, d = q.shape
    q, k, v, do = _aligned(flash_backward_dkv, [q, k, v, do])
    dk, dv = _btdh(k), _btdh(v)
    l, m, di = l.contiguous(), m.contiguous(), di.contiguous()
    strides = _launch_args([q, k, v, do], [dk, dv])
    with torch.cuda.device(q.device):
        err = lib.bf_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            l.data_ptr(), m.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), strides, b, h, t, d, int(causal), float(scale),
            DTYPES[q.dtype][0], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_backward_dkv launch failed: cudaError "
                           f"{err}")
    flash_backward_dkv.launches += 1
    return dk, dv


def flash_backward_dq(q, k, v, do, l, m, o, *, causal: bool, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dQ kernel: ``(dq, di)``, with ``o`` the forward's output and
    ``di = sum(o * do, -1)`` in f32, which :func:`flash_backward_dkv` takes
    (``l`` and ``m`` as there; CPU tensors take
    :func:`flash_backward_dq_plain`)."""
    _check(q, k, v, ("do", do), ("o", o))
    _check_rows(q, ("l", l), ("m", m))
    if not _on_card(q, "flash_backward_dq"):
        return flash_backward_dq_plain(q, k, v, do, l, m, o, causal=causal,
                                       scale=scale)
    from bluefog_tpu_torch.ops import _build

    lib = _build.load()
    b, h, t, d = q.shape
    q, k, v, do, o = _aligned(flash_backward_dq, [q, k, v, do, o])
    dq = _btdh(q)
    di = torch.empty(b, h, t, dtype=torch.float32, device=q.device)
    l, m = l.contiguous(), m.contiguous()
    strides = _launch_args([q, k, v, do, o], [dq])
    with torch.cuda.device(q.device):
        err = lib.bf_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            o.data_ptr(), l.data_ptr(), m.data_ptr(), di.data_ptr(),
            dq.data_ptr(), strides, b, h, t, d, int(causal), float(scale),
            DTYPES[q.dtype][0], _stream(q))
    if err != 0:
        raise RuntimeError(f"flash_backward_dq launch failed: cudaError {err}")
    flash_backward_dq.launches += 1
    return dq, di


flash_forward.launches = 0
flash_backward_dkv.launches = 0
flash_backward_dq.launches = 0
flash_forward.copies = 0
flash_backward_dkv.copies = 0
flash_backward_dq.copies = 0


class FlashAttention(torch.autograd.Function):
    """``o = softmax(q k^T scale) v`` through the forward wrapper, its
    gradient through the two backward wrappers; saves q, k, v, o, l and m
    (no ``(T, T)`` tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, l, m = flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, di = flash_backward_dq(q, k, v, do, l, m, o, causal=ctx.causal,
                                   scale=ctx.scale)
        dk, dv = flash_backward_dkv(q, k, v, do, l, m, di, causal=ctx.causal,
                                    scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """The library's ``flash_attention(q, k, v, causal=, sm_scale=)`` on
    ``(B, H, T, D)`` q, k, v: K3 with its gradient, or its twins on CPU
    tensors."""
    return FlashAttention.apply(q, k, v, causal, float(sm_scale))
