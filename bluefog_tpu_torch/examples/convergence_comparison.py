"""Convergence parity: decentralized gossip against centralized allreduce.

Counterpart of ``examples/convergence_comparison.py`` of the JAX package.
The reference's core claim (Bluefog paper, arXiv:2111.04287) is that
decentralized SGD over a well-chosen topology matches centralized allreduce
SGD in final accuracy while communicating less.  This script trains the same
LeNet from the same weights on the same skewed per-rank shards under four
flavors (allreduce; exp2 and ring gossip, each step one K1 launch per fused
buffer on the card; no communication) and evaluates every rank on one
shared held-out set drawn from the same class prototypes.

Asserted, as the JAX example does: exp2 gossip lands within 0.05 and ring
gossip within 0.08 of allreduce's mean accuracy; and the isolated ranks,
each stuck on its own skewed shard, trail allreduce.  The data is drawn with
``numpy.random.default_rng`` (the JAX example uses ``jax.random``), so the
numbers differ from the JAX run's.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.convergence_comparison \\
      [--epochs 6] [--batch 32] [--lr 0.02] [--n-per-rank 512] [--size 8]

and on the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.examples.synthetic_benchmark import Trainer, image_loss
from bluefog_tpu_torch.models import LeNet5
from bluefog_tpu_torch.optim import CommunicationType, decentralized_optimizer
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.topology import ExponentialTwoGraph, RingGraph

__all__ = ["make_dataset", "train_flavor", "main"]


def make_dataset(n_per_rank: int, n_ranks: int, seed: int = 1,
                 noise: float = 0.6
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prototype MNIST stand-in with heterogeneous shards: rank ``r``
    over-samples the classes around ``9 r / (n - 1)``.  Returns ``(images
    (n, m, 28, 28, 1) f32, labels (n, m) int64, prototypes (10, 28, 28, 1)
    f32)``, the prototypes for drawing eval sets from the same
    distribution."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((10, 28, 28, 1)) * 0.8
    logits = -0.5 * ((np.arange(10)[None, :]
                      - np.linspace(0, 9, n_ranks)[:, None]) ** 2)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = np.stack([rng.choice(10, size=n_per_rank, p=p) for p in probs])
    imgs = protos[labels] + noise * rng.standard_normal(
        (n_ranks, n_per_rank, 28, 28, 1))
    return (imgs.astype(np.float32), labels.astype(np.int64),
            protos.astype(np.float32))


def train_flavor(comm_type: CommunicationType, topology, data, eval_data,
                 args, device) -> Tuple[float, float, float, float]:
    """Train one flavor from LeNet's seed-0 weights; returns the mean, min
    and max over the ranks of their accuracy on the shared eval set, and
    the last epoch's mean training loss."""
    n = args.size
    model = LeNet5(generator=torch.Generator().manual_seed(0)).to(device)
    params = bf.rank_stack(dict(model.named_parameters()), n, device)
    for p in params.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    opt = decentralized_optimizer(
        torch.optim.SGD(list(params.values()), lr=args.lr, momentum=0.9),
        topology, communication_type=comm_type)
    trainer = Trainer(model, params, {}, opt, None, image_loss)
    imgs, labels = data
    nb = imgs.shape[1] // args.batch
    if nb < 1:
        raise ValueError(f"--batch {args.batch} > examples per rank "
                         f"{imgs.shape[1]}")
    gen = torch.Generator().manual_seed(13)
    losses = []
    for _ in range(args.epochs):
        # one permutation of the examples for every rank, as the JAX
        # example's replicated perm
        perm = torch.randperm(imgs.shape[1], generator=gen).to(device)
        x, y = imgs[:, perm], labels[:, perm]
        losses = [trainer.step((x[:, i * args.batch:(i + 1) * args.batch],
                                y[:, i * args.batch:(i + 1) * args.batch]))
                  for i in range(nb)]
    ex, ey = eval_data
    with torch.no_grad():
        accs = np.array([
            float((functional_call(model, {k: v[r] for k, v in
                                           params.items()}, (ex,))
                   .argmax(-1) == ey).float().mean())
            for r in range(n)])
    loss = float(torch.stack(losses).mean())
    return float(accs.mean()), float(accs.min()), float(accs.max()), loss


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--n-per-rank", type=int, default=512)
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n = args.size
    imgs, labels, protos = make_dataset(args.n_per_rank, n)
    data = (torch.from_numpy(imgs).to(dev), torch.from_numpy(labels).to(dev))
    # shared balanced eval set drawn from the same prototypes
    ey = np.tile(np.arange(10), 40)
    ex = protos[ey] + 0.6 * np.random.default_rng(99).standard_normal(
        (ey.shape[0], 28, 28, 1)).astype(np.float32)
    eval_data = (torch.from_numpy(ex).to(dev), torch.from_numpy(ey).to(dev))

    flavors = [
        ("allreduce", CommunicationType.allreduce, None),
        ("exp2 gossip", CommunicationType.neighbor_allreduce,
         ExponentialTwoGraph(n)),
        ("ring gossip", CommunicationType.neighbor_allreduce, RingGraph(n)),
        ("no comm", CommunicationType.empty, None),
    ]
    print(f"ranks={n} epochs={args.epochs} per-rank={args.n_per_rank} "
          f"(heterogeneous shards)\n")
    print(f"{'flavor':<14} {'eval acc':>9} {'min rank':>9} {'max rank':>9} "
          f"{'train loss':>11}")
    results = {}
    t0 = time.perf_counter()
    for name, ct, topo in flavors:
        acc, lo, hi, loss = train_flavor(ct, topo, data, eval_data, args,
                                         dev)
        results[name] = acc
        print(f"{name:<14} {acc:>9.4f} {lo:>9.4f} {hi:>9.4f} {loss:>11.4f}")
    seconds = time.perf_counter() - t0
    gap_exp2 = results["allreduce"] - results["exp2 gossip"]
    gap_ring = results["allreduce"] - results["ring gossip"]
    gap_none = results["allreduce"] - results["no comm"]
    print(f"\ngossip-vs-allreduce gap: exp2 {gap_exp2:+.4f}, "
          f"ring {gap_ring:+.4f}; no comm {gap_none:+.4f}")
    if gap_exp2 > 0.05 or gap_ring > 0.08:
        raise RuntimeError("gossip trails allreduce beyond tolerance "
                           "(short run? try more --epochs)")
    if not gap_none > 0:
        raise RuntimeError("the isolated ranks did not trail allreduce")
    print("OK: decentralized matches centralized (the reference's claim)")
    return {"acc": results, "seconds": seconds,
            "steps": args.epochs * (args.n_per_rank // args.batch)}


if __name__ == "__main__":
    main()
