"""Decentralized ResNet-50 ImageNet training over ``n`` virtual ranks.

Counterpart of ``examples/imagenet_resnet.py`` of the JAX package
(BASELINE.json ``configs[1]``: ResNet-50 on ImageNet over Exponential-2 with
``DistributedNeighborAllreduceOptimizer``), with ``--optimizer allreduce``
for the centralized baseline (``DistributedGradientAllreduceOptimizer``).
Each rank trains its own replica, a row of rank-stacked parameters, on a
disjoint shard; a step runs every rank's forward and backward on its batch
(``synthetic_benchmark.Trainer.step``), then the optimizer step: gossip
through the kernel K1 with ``neighbor``, the gradients' mean with
``allreduce``.  The ranks are virtual, on one device: an allreduce moves no
bytes between cards here, so the two optimizers' step times compare the
update paths, not their communication.

The recipe is the JAX example's: the linear-scaling learning rate with a
linear warm-up then cosine decay, set on the base optimizer every step;
weight decay 1e-4 and Nesterov SGD with momentum 0.9 (``optax.chain(
add_decayed_weights, sgd(nesterov=True))`` there, ``torch.optim.SGD(
weight_decay=, nesterov=True)`` here); label-smoothed cross-entropy; raw
``uint8`` images mapped to ``x / 127.5 - 1`` in the compute dtype; the
BatchNorm statistics averaged over the ranks before evaluation (they are not
gossiped); top-1 on the validation shards.

Data: ``--data-dir`` holding ``train-*.tfrecord`` / ``val-*.tfrecord``
shards (``bluefog_tpu_torch.data.write_image_classification_shards``) or
``{train,val}_{images,labels}.npy`` pairs (memory-mapped); without it, a
deterministic synthetic source of the same shapes.  ``--checkpoint-dir`` and
``--resume`` need ``utils/checkpoint.py``, which comes with the port's host
runtime; until then they raise.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.imagenet_resnet --data-dir DIR \\
      --batch-size 32 --epochs 2 --warmup-epochs 1

and on the CPU at a small size::

  python -m bluefog_tpu_torch.examples.imagenet_resnet --device cpu \\
      --image-size 32 --num-filters 8 --num-classes 10 --batch-size 2 \\
      --steps-per-epoch 2 --epochs 2 --fp32
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

import bluefog_tpu_torch as bf
from bluefog_tpu_torch.data import (
    ArraySource,
    DistributedLoader,
    SyntheticClassificationSource,
    TFRecordSource,
)
from bluefog_tpu_torch.examples.synthetic_benchmark import (
    TOPOLOGIES, Trainer, profile_step)
from bluefog_tpu_torch.models import ResNet50
from bluefog_tpu_torch.optim import (
    DecentralizedOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
)

__all__ = ["parse_args", "make_sources", "lr_schedule", "prepare",
           "SmoothedLoss", "build_trainer", "set_lr", "evaluate", "main"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None,
                    help="dir with {train,val}-*.tfrecord shards or "
                         "{train,val}_{images,labels}.npy; synthetic if unset")
    ap.add_argument("--epochs", type=int, default=90)
    ap.add_argument("--steps-per-epoch", type=int, default=32,
                    help="synthetic epoch length (ignored with --data-dir)")
    ap.add_argument("--batch-size", type=int, default=128,
                    help="per-rank batch")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--num-filters", type=int, default=64,
                    help="the ResNet's width (64: ResNet-50)")
    ap.add_argument("--lr", type=float, default=0.1,
                    help="base lr at batch 256")
    ap.add_argument("--warmup-epochs", type=int, default=5)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--topology", choices=sorted(TOPOLOGIES), default="exp2")
    ap.add_argument("--optimizer", choices=["neighbor", "allreduce"],
                    default="neighbor",
                    help="decentralized gossip vs centralized baseline")
    ap.add_argument("--atc", action="store_true", help="adapt-then-combine")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    metavar="EPOCHS")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-every", type=int, default=1, metavar="EPOCHS")
    ap.add_argument("--stem", choices=["conv", "s2d"], default="conv",
                    help="s2d = space-to-depth stem")
    ap.add_argument("--fp32", action="store_true",
                    help="train in float32 (default bfloat16)")
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="run each epoch's last step under torch.profiler "
                         "(on the card): device busy time and idle share; "
                         "the profiler's reading of its trace is left out "
                         "of the epoch's time")
    return ap.parse_args(argv)


def make_sources(args, n_ranks: int):
    """``(train, val)``: TFRecord shards or ``.npy`` pairs from
    ``--data-dir``, else synthetic sources of ``steps_per_epoch`` batches."""
    if args.data_dir:
        # TFRecord shards take precedence; else memory-mapped .npy pairs
        if glob.glob(os.path.join(args.data_dir, "train-*.tfrecord")):
            return (TFRecordSource(
                        os.path.join(args.data_dir, "train-*.tfrecord")),
                    TFRecordSource(
                        os.path.join(args.data_dir, "val-*.tfrecord")))

        def load(name):
            return np.load(os.path.join(args.data_dir, name), mmap_mode="r")

        return (ArraySource(load("train_images.npy"),
                            load("train_labels.npy")),
                ArraySource(load("val_images.npy"), load("val_labels.npy")))
    shape = (args.image_size, args.image_size, 3)
    n_train = args.steps_per_epoch * args.batch_size * n_ranks
    train = SyntheticClassificationSource(
        n_train, shape=shape, num_classes=args.num_classes, seed=0)
    val = SyntheticClassificationSource(
        max(n_train // 8, args.batch_size * n_ranks), shape=shape,
        num_classes=args.num_classes, seed=1)
    return train, val


def lr_schedule(lr: float, batch_size: int, warmup_epochs: int, epochs: int,
                steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of each update: the linear-scaling rule's base
    ``lr * batch_size / 256``, a linear warm-up from 0 over
    ``warmup_epochs``, then cosine decay to 0 over the remaining epochs (at
    least one), as ``optax.join_schedules([linear_schedule,
    cosine_decay_schedule])`` computes it."""
    base = lr * batch_size / 256.0
    warmup = warmup_epochs * steps_per_epoch
    decay = max(epochs - warmup_epochs, 1) * steps_per_epoch

    def sched(step: int) -> float:
        if step < warmup:
            return base * step / warmup
        t = min(step - warmup, decay)
        return base * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return sched


def prepare(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Raw ``uint8`` images mapped from [0, 255] to [-1, 1] in ``dtype``;
    other inputs cast to ``dtype``."""
    if x.dtype == torch.uint8:
        return x.to(dtype) / 127.5 - 1.0
    return x.to(dtype)


class SmoothedLoss:
    """The per-rank loss of a train-mode ResNet: softmax cross-entropy
    against labels smoothed by ``smoothing`` (optax's ``smooth_labels``:
    ``(1 - s) onehot + s / C``).  Counts the correct top-1 predictions in
    :attr:`hits`, a device tensor."""

    def __init__(self, smoothing: float, dtype: torch.dtype):
        self.smoothing, self.dtype = smoothing, dtype
        self.hits = 0

    def __call__(self, model, variables, batch) -> torch.Tensor:
        images, labels = batch
        labels = labels.long()
        logits = functional_call(model, variables,
                                 (prepare(images, self.dtype),),
                                 {"train": True})
        with torch.no_grad():
            self.hits = self.hits + (logits.argmax(-1) == labels).sum()
        return F.cross_entropy(logits, labels,
                               label_smoothing=self.smoothing)


def build_trainer(args, n_ranks: int, device) -> Trainer:
    """The ranks' ResNet-50 (weights from ``--seed``, the same on every
    rank), Nesterov SGD with weight decay under the chosen optimizer, and
    the label-smoothed loss; every step is given its batch."""
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    net = ResNet50(num_classes=args.num_classes, num_filters=args.num_filters,
                   dtype=dtype, stem=args.stem,
                   generator=torch.Generator().manual_seed(args.seed)
                   ).to(device)
    params = bf.rank_stack(dict(net.named_parameters()), n_ranks, device)
    for p in params.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    buffers = bf.rank_stack(dict(net.named_buffers()), n_ranks, device)
    base = torch.optim.SGD(list(params.values()), lr=0.0, momentum=0.9,
                           nesterov=True, weight_decay=args.weight_decay)
    opt: DecentralizedOptimizer
    if args.optimizer == "neighbor":
        opt = DistributedNeighborAllreduceOptimizer(
            base, topology=TOPOLOGIES[args.topology](n_ranks), atc=args.atc)
    else:
        opt = DistributedGradientAllreduceOptimizer(base)
    return Trainer(net, params, buffers, opt, None,
                   SmoothedLoss(args.label_smoothing, dtype))


def set_lr(trainer: Trainer, lr: float) -> None:
    """The base optimizer's learning rate for the next step."""
    for group in trainer.opt.param_groups:
        group["lr"] = lr


@torch.no_grad()
def evaluate(trainer: Trainer, buffers: Dict[str, torch.Tensor],
             loader: DistributedLoader) -> int:
    """Top-1 hits of every rank on its validation shard, with ``buffers``
    as the BatchNorm statistics."""
    dtype = trainer.loss_fn.dtype
    hits = torch.zeros((), dtype=torch.long, device=trainer.device)
    for x, y in loader.epoch(0):
        for r in range(trainer.size):
            variables = ({k: v[r] for k, v in trainer.params.items()},
                         {k: v[r] for k, v in buffers.items()})
            logits = functional_call(trainer.model, variables,
                                     (prepare(x[r], dtype),),
                                     {"train": False})
            hits += (logits.argmax(-1) == y[r].long()).sum()
    return int(hits)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = parse_args(argv)
    if args.checkpoint_dir or args.resume:
        raise NotImplementedError(
            "--checkpoint-dir and --resume need utils/checkpoint.py, which "
            "is not ported yet: it comes with the host runtime")
    n = args.size
    ctx = bf.init(topology=TOPOLOGIES[args.topology](n), device=args.device)
    try:
        return _train(args, ctx)
    finally:
        bf.shutdown()


def _train(args, ctx) -> Dict[str, object]:
    n, dev = ctx.size, ctx.device
    print(f"ranks={n} topology={args.topology} optimizer={args.optimizer} "
          f"dtype={'float32' if args.fp32 else 'bfloat16'} device={dev}")
    train_src, val_src = make_sources(args, n)
    loader = DistributedLoader(train_src, args.batch_size, seed=args.seed)
    val_loader = DistributedLoader(val_src, args.batch_size, shuffle=False)
    spe = loader.steps_per_epoch
    sched = lr_schedule(args.lr, args.batch_size, args.warmup_epochs,
                        args.epochs, spe)
    trainer = build_trainer(args, n, dev)
    images_per_epoch = spe * args.batch_size * n
    epochs: List[Dict[str, object]] = []
    losses: List[np.ndarray] = []
    step = 0
    for epoch in range(args.epochs):
        trainer.loss_fn.hits = 0
        # host seconds the profiler spends reading its trace after the
        # profiled step: not part of training, left out of the epoch's time
        wait_s, prof_s, prof, loss = 0.0, 0.0, None, None
        _sync(dev)
        t0 = time.perf_counter()
        it = iter(loader.epoch(epoch))
        for i in range(spe):
            tw = time.perf_counter()
            batch = next(it)
            wait_s += time.perf_counter() - tw
            set_lr(trainer, sched(step))
            if args.profile and i == spe - 1:
                tp = time.perf_counter()
                prof = profile_step(trainer, batch=batch)
                prof_s = time.perf_counter() - tp - prof["wall_ms"] / 1e3
                loss = prof["losses"]
            else:
                loss = trainer.step(batch)
            losses.append(loss)
            step += 1
        _sync(dev)
        dt = time.perf_counter() - t0 - prof_s
        row = {"loss": float(loss.float().mean()),
               "train_acc": int(trainer.loss_fn.hits) / images_per_epoch,
               "img_per_s": images_per_epoch / dt,
               "loader_wait_ms": wait_s / spe * 1e3,
               "step_ms": dt / spe * 1e3}
        if prof is not None:
            row["idle_share"] = prof["idle_share"]
            row["profiled_step_ms"] = prof["wall_ms"]
        print(f"epoch {epoch:3d}  loss {row['loss']:.4f}  train-acc "
              f"{row['train_acc']:.3f}  {row['img_per_s']:,.1f} img/s "
              f"({row['img_per_s'] / n:,.1f}/rank)  loader wait "
              f"{row['loader_wait_ms']:.2f} ms/step  lr "
              f"{sched(step - 1):.4f}"
              + (f"  profiled step {prof['wall_ms']:.2f} ms, device idle "
                 f"{prof['idle_share']:.1%}" if prof is not None else ""))
        if args.eval_every and (epoch + 1) % args.eval_every == 0:
            # the BatchNorm statistics are not gossiped: average them over
            # the ranks before they are read (training keeps its own)
            synced = bf.allreduce(trainer.buffers)
            hits = evaluate(trainer, synced, val_loader)
            total = val_loader.steps_per_epoch * args.batch_size * n
            row["val_top1"] = hits / total
            print(f"          val top-1 {hits / total:.4f}  ({hits}/{total})")
        epochs.append(row)
    print("OK")
    return {"epochs": epochs,
            "losses": [loss.float().cpu().numpy() for loss in losses],
            "trainer": trainer}


if __name__ == "__main__":
    main()
