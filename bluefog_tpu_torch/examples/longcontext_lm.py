"""Long-context LM training with sequence parallelism (ring / Ulysses).

Counterpart of ``examples/longcontext_lm.py`` of the JAX package.  The global
sequence is sharded over ``--ranks`` virtual ranks of a sequence-parallel
axis: with ``--attn ring`` the KV blocks rotate around the ranks
(:func:`~bluefog_tpu_torch.ops.ring_attention.ring_attention`), with
``ring-zigzag`` in the load-balanced causal layout, and with ``ulysses``
the ranks trade sequence shards for head shards
(:func:`~bluefog_tpu_torch.ops.ring_attention.all_to_all_attention`, with
``backend='auto'``, so K3 runs where it is eligible).  ``--remat``
checkpoints each block.

Task: synthetic induction.  The sequence repeats with period ``--period``,
longer than a rank's block, so the next-token loss falls only if attention
reaches across shard boundaries.  The targets are the next tokens of the
global sequence (the first token of the next rank's block at a boundary,
the sequence wrapping at its end), and in the zigzag layout each token's
global position is given explicitly.  The parameters are one copy shared by
the ranks: the gradient of the mean loss over every rank's tokens is the
reference's ``pmean`` of the ranks' gradients.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.longcontext_lm --attn ring

and on the CPU::

  python -m bluefog_tpu_torch.examples.longcontext_lm --device cpu \\
      --attn ulysses

It prints ``OK`` when the loss has fallen below 0.7 of its first value, and
exits with status 1 otherwise.

Under ``bfrun`` (``python -m bluefog_tpu_torch.runtime.launch -np P -m
bluefog_tpu_torch.examples.longcontext_lm ...``) the ``--ranks`` ranks of
the axis are spread over the P processes: each holds its block of the
sequence, the KV rotation or the all-to-all crosses the processes
(:mod:`bluefog_tpu_torch.parallel.axes`), and each process's gradient of its
tokens' share of the loss is summed over the processes
(:func:`~bluefog_tpu_torch.parallel.axes.reduce_partials`) before the step,
so every process keeps the same parameters.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bluefog_tpu_torch.models.transformer import GPTConfig, TransformerLM
from bluefog_tpu_torch.ops.ring_attention import (
    all_to_all_attention, ring_attention, zigzag_shard)
from bluefog_tpu_torch.parallel import axes as ax
from bluefog_tpu_torch.parallel.context import resolve_device

__all__ = ["make_batch", "shard_sequence", "main"]

ATTNS = ("ring", "ring-zigzag", "ulysses")


def make_batch(seed: int, batch: int, t_global: int, vocab: int,
               period: int) -> np.ndarray:
    """Periodic sequences ``(batch, t_global)``: a random motif of ``period``
    tokens in ``[1, vocab)``, repeated."""
    motif = np.random.default_rng(seed).integers(1, vocab, (batch, period))
    reps = -(-t_global // period)
    return np.tile(motif, (1, reps))[:, :t_global]


def shard_sequence(tokens: torch.Tensor, n: int, zigzag: bool):
    """``(tokens, targets, positions)`` stacked by rank, ``(n, B,
    T / n)``: the next-token targets of the global sequence (wrapping at its
    end), cut like the tokens, and each token's global position, ``(n, 1,
    T / n)``."""
    t_global = tokens.shape[1]
    targets = torch.roll(tokens, -1, dims=1)
    pos = torch.arange(t_global, device=tokens.device)[None]
    if zigzag:
        tokens, targets, pos = (zigzag_shard(t, n) for t in
                                (tokens, targets, pos))
    split = lambda t: t.unflatten(1, (n, -1)).transpose(0, 1)  # noqa: E731
    return split(tokens), split(targets), split(pos)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--attn", choices=ATTNS, default="ring")
    ap.add_argument("--ranks", type=int, default=8,
                    help="virtual ranks of the sequence-parallel axis")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--t-local", type=int, default=64,
                    help="sequence tokens per rank")
    ap.add_argument("--period", type=int, default=128,
                    help="repeat period; must divide the global length and "
                         "exceed t-local to force cross-shard attention")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import bluefog_tpu_torch as bf
    from bluefog_tpu_torch.runtime.launch import initialize_cluster

    initialize_cluster()
    dev = resolve_device(args.device)
    n = args.ranks
    t_global = n * args.t_local
    if args.period >= t_global:
        raise SystemExit("--period must be < global sequence length")
    if t_global % args.period:
        # else the wrap-around target breaks the periodicity
        raise SystemExit(f"--period {args.period} must divide the global "
                         f"sequence length {t_global}")
    zigzag = args.attn == "ring-zigzag"
    if zigzag and args.t_local % 2:
        raise SystemExit("--t-local must be even for ring-zigzag")
    spread = torch.distributed.is_initialized() and (
        torch.distributed.get_world_size() > 1)
    axis, talk = ax.Axis("sp", n, 0), True
    if spread:
        # each process holds its block of the context's n ranks
        ctx = bf.init(size=n, device=dev)
        dev = ctx.device
        axis = ax.make_hybrid_mesh({"sp": n}).axis("sp")
        talk = ctx.process_rank == 0
    own = slice(axis.start, axis.start + axis.local)

    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=8, max_position=t_global, dtype=torch.float32,
                    remat=args.remat)
    model = TransformerLM(cfg, torch.Generator().manual_seed(args.seed)
                          ).to(dev)
    if talk:
        print(f"ranks={n} global_seq={t_global} attn={args.attn} "
              f"period={args.period} remat={args.remat} device={dev}"
              + (f" processes={ctx.process_count}" if spread else ""))
    if args.attn == "ulysses":
        attn = functools.partial(all_to_all_attention, axis=axis,
                                 causal=True, backend="auto")
    else:
        attn = functools.partial(ring_attention, axis=axis, causal=True,
                                 layout="zigzag" if zigzag else "contiguous")

    tokens = torch.from_numpy(make_batch(args.seed + 1, args.batch, t_global,
                                         cfg.vocab_size, args.period)).to(dev)
    toks, tgts, pos = (t[own] for t in shard_sequence(tokens, n, zigzag))
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    params = list(model.parameters())

    losses = []
    t0 = time.perf_counter()
    for s in range(args.steps):
        logits = model(toks, attn_fn=attn, positions=pos)
        # this process's tokens' share of the mean over all of them
        loss = F.cross_entropy(logits.flatten(0, -2), tgts.flatten(),
                               reduction="sum") / tokens.numel()
        grads = torch.autograd.grad(loss, params)
        *grads, total = ax.reduce_partials([*grads, loss.detach()], axis)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        losses.append(float(total))
        if talk and (s % 10 == 0 or s == args.steps - 1):
            print(f"step {s:4d}  loss {losses[-1]:.4f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tps = args.steps * args.batch * t_global / dt
    ok = losses[-1] <= 0.7 * losses[0]
    if talk:
        print(f"\n{tps:,.0f} tokens/s total ({tps / n:,.0f}/rank)  loss "
              f"{losses[0]:.3f} -> {losses[-1]:.3f}")
        print("OK: induction learned across shard boundaries" if ok else
              "FAIL: loss barely moved; cross-shard attention suspect")
    if spread:
        bf.shutdown()
    return {"losses": losses, "tokens_s": tps, "ok": ok}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
