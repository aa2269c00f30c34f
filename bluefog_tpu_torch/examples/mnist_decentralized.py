"""Decentralized LeNet training on MNIST-shaped data over ``n`` virtual ranks.

Counterpart of ``examples/mnist_decentralized.py`` of the JAX package, the
reference's ``examples/pytorch_mnist.py`` (BASELINE.json ``configs[0]``:
LeNet on a ring topology with ``neighbor_allreduce``).  Each rank holds its
own LeNet as a row of rank-stacked parameters and its own data shard; every
step runs each rank's forward and backward on its next batch, then
:func:`~bluefog_tpu_torch.optim.DistributedNeighborAllreduceOptimizer` (SGD,
momentum 0.9) gossips the parameters with the ring neighbours through the
kernel K1.  After training, ``allreduce_parameters`` averages the ranks.

MNIST is synthesized, as in the JAX example: 10 fixed random class
prototypes plus noise.  The JAX example draws them with ``jax.random``; this
one draws the same recipe from numpy's ``default_rng(seed)``, so the numbers
differ and the two agree on data both are given (the tests do that).  The
JAX example's ``metrics.health`` hook does nothing unless metrics are on, and
comes with the metrics package.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.mnist_decentralized

and on the CPU at a small size::

  python -m bluefog_tpu_torch.examples.mnist_decentralized --device cpu \\
      --n-per-rank 128 --epochs 2
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.examples.synthetic_benchmark import Trainer, image_loss
from bluefog_tpu_torch.models import LeNet5
from bluefog_tpu_torch.optim import DistributedNeighborAllreduceOptimizer
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.topology import RingGraph

__all__ = ["make_dataset", "build", "local_accuracy", "train", "main"]


def make_dataset(n_per_rank: int, n_ranks: int, seed: int = 42,
                 noise: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic MNIST: 10 random 28x28x1 prototypes plus Gaussian noise;
    ``(images (n_ranks, n_per_rank, 28, 28, 1) f32, labels (n_ranks,
    n_per_rank) int64)``."""
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((10, 28, 28, 1)).astype(np.float32) * 0.8
    labels = rng.integers(0, 10, (n_ranks, n_per_rank))
    noise_img = rng.standard_normal((n_ranks, n_per_rank, 28, 28, 1))
    imgs = protos[labels] + np.float32(noise) * noise_img.astype(np.float32)
    return imgs.astype(np.float32), labels.astype(np.int64)


def build(size: int = 8, lr: float = 0.01, atc: bool = False, seed: int = 0,
          device="cuda") -> Trainer:
    """``size`` ranks of one LeNet (weights from ``seed``, the same on every
    rank) under ring gossip SGD with momentum 0.9; every step is given its
    batch."""
    dev = resolve_device(device)
    model = LeNet5(generator=torch.Generator().manual_seed(seed)).to(dev)
    params = bf.rank_stack(dict(model.named_parameters()), size, dev)
    for p in params.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    opt = DistributedNeighborAllreduceOptimizer(
        torch.optim.SGD(list(params.values()), lr=lr, momentum=0.9),
        topology=RingGraph(size), atc=atc)
    return Trainer(model, params, {}, opt, None, image_loss)


@torch.no_grad()
def local_accuracy(trainer: Trainer, imgs: torch.Tensor,
                   labels: torch.Tensor) -> np.ndarray:
    """Each rank's accuracy on its own data, ``(n,)``."""
    accs = []
    for r in range(trainer.size):
        p_r = {k: v[r] for k, v in trainer.params.items()}
        logits = functional_call(trainer.model, p_r, (imgs[r],))
        accs.append((logits.argmax(-1) == labels[r]).float().mean())
    return torch.stack(accs).cpu().numpy()


def train(trainer: Trainer, imgs: torch.Tensor, labels: torch.Tensor,
          epochs: int, batch_size: int) -> List[Dict[str, np.ndarray]]:
    """``epochs`` passes over each rank's data in order, ``batch_size``
    examples a step; per epoch, the ranks' mean losses and their local
    accuracies after it."""
    steps = imgs.shape[1] // batch_size
    out = []
    for _ in range(epochs):
        losses = []
        for i in range(steps):
            sl = slice(i * batch_size, (i + 1) * batch_size)
            losses.append(trainer.step((imgs[:, sl], labels[:, sl])))
        out.append({"loss": torch.stack(losses).mean(0).cpu().numpy(),
                    "acc": local_accuracy(trainer, imgs, labels)})
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=32,
                    help="per-rank batch")
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--n-per-rank", type=int, default=512)
    ap.add_argument("--atc", action="store_true", help="adapt-then-combine")
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    ctx = bf.init(topology=RingGraph(args.size), device=args.device)
    try:
        print(f"ranks={args.size} topology={bf.load_topology().name} "
              f"device={ctx.device}")
        trainer = build(args.size, args.lr, args.atc, args.seed, ctx.device)
        imgs, labels = make_dataset(args.n_per_rank, args.size)
        imgs = torch.from_numpy(imgs).to(ctx.device)
        labels = torch.from_numpy(labels).to(ctx.device)
        epochs = train(trainer, imgs, labels, args.epochs, args.batch_size)
        for e, row in enumerate(epochs):
            print(f"epoch {e}: mean loss {row['loss'].mean():.4f}  "
                  f"mean local acc {row['acc'].mean():.3f}")
        # post-training consensus average (reference:
        # bf.allreduce_parameters)
        with torch.no_grad():
            for p, avg in zip(trainer.params.values(),
                              bf.allreduce_parameters(
                                  list(trainer.params.values()))):
                p.copy_(avg)
        final_acc = float(epochs[-1]["acc"].mean())
        total_steps = args.n_per_rank // args.batch_size * args.epochs
        if total_steps >= 30:
            if not final_acc > 0.9:
                raise RuntimeError(
                    f"training failed to learn (acc={final_acc})")
            print("OK")
        else:
            print(f"OK (only {total_steps} steps run; acc={final_acc:.3f}: "
                  "too few steps for the convergence check)")
        return {"epochs": epochs, "final_acc": final_acc,
                "total_steps": total_steps, "trainer": trainer}
    finally:
        bf.shutdown()


if __name__ == "__main__":
    main()
