"""Synthetic throughput benchmark: decentralized SGD of a model over ``n``
virtual ranks on one device.

Counterpart of ``examples/synthetic_benchmark.py`` of the JAX package for its
LeNet, ResNet models and GPT-small, and its ``neighbor``, ``hierarchical``,
``allreduce``, ``winput`` and ``none`` communication flavors.  Each rank
holds its own copy of the model as a row of rank-stacked parameters; a step
runs every rank's forward and backward in turn on that rank's batch, through
the model's own per-rank loss, then one optimizer step: with ``neighbor``,
:func:`~bluefog_tpu_torch.optim.DistributedNeighborAllreduceOptimizer`, whose
gossip is one call of the kernel K1 per fused buffer; with ``hierarchical``,
:func:`~bluefog_tpu_torch.optim.DistributedHierarchicalNeighborAllreduceOptimizer`
over machines of ``--local-size`` ranks on a ring of machines, whose machine
gossip is one call of K1 per fused buffer; with ``allreduce``,
:func:`~bluefog_tpu_torch.optim.DistributedGradientAllreduceOptimizer`, the
centralized baseline, which averages the gradients; with ``winput``,
:func:`~bluefog_tpu_torch.optim.DistributedWinPutOptimizer`, whose put is one
call of the kernel K2 per dtype of the parameters.  The ranks are virtual, on
one device, so no flavor moves bytes between cards: their step times compare
the update paths, not their communication.

The ResNets classify random NHWC images (softmax cross-entropy against random
labels), LeNet random 28x28x1 images into 10 classes.  BatchNorm runs in train mode with per-rank batch statistics that
are not gossiped, as in the JAX package's decentralized training step
(``__graft_entry__.py::dryrun_multichip``, ``examples/imagenet_resnet.py``);
the JAX benchmark instead freezes BatchNorm.  ``gpt-small`` is
``TransformerLM(GPTConfig.small())`` on random tokens of ``--seq-len``
(default 128, at most its 8192 positions), with the JAX benchmark's loss:
softmax cross-entropy of the logits against the tokens rolled by one
(``jnp.roll(ids, -1)``: the last position's target is the first token); its
attention runs on the kernel K3 wherever ``local_attention`` allows it.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.synthetic_benchmark \\
      --model resnet50 --comm neighbor --topology exp2 --size 8
  python -m bluefog_tpu_torch.examples.synthetic_benchmark \\
      --model gpt-small --comm neighbor --batch-size 8 --seq-len 1024

(``--comm winput`` for the one-sided window optimizer, ``--comm allreduce``
for the centralized baseline, ``--comm hierarchical --local-size 2`` for
machines of two ranks) and on the CPU at a toy size::

  python -m bluefog_tpu_torch.examples.synthetic_benchmark --device cpu \\
      --model resnet18 --image-size 32 --batch-size 2 --size 4 --iters 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from bluefog_tpu_torch.models import (
    GPTConfig, LeNet5, ResNet18, ResNet50, TransformerLM)
from bluefog_tpu_torch.optim import (
    CommunicationType,
    DecentralizedOptimizer,
    DistributedGradientAllreduceOptimizer,
    DistributedHierarchicalNeighborAllreduceOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedWinPutOptimizer,
    decentralized_optimizer,
)
from bluefog_tpu_torch.parallel.api import rank_stack
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.topology import (
    ExponentialTwoGraph, MeshGrid2DGraph, RingGraph)

__all__ = ["MODELS", "TOPOLOGIES", "COMMS", "Trainer", "image_loss",
           "lm_loss", "make_optimizer", "build", "run", "profile_step",
           "main"]

# (params, buffers) of one rank, its batch -> its scalar loss
LossFn = Callable[[torch.nn.Module, Tuple[Dict, Dict],
                   Tuple[torch.Tensor, ...]], torch.Tensor]


def image_loss(model, variables, batch) -> torch.Tensor:
    """Softmax cross-entropy of a train-mode ResNet on ``(images, labels)``;
    BatchNorm updates the rank's buffers in place."""
    images, labels = batch
    logits = functional_call(model, variables, (images,), {"train": True})
    return F.cross_entropy(logits, labels)


def lm_loss(model, variables, batch) -> torch.Tensor:
    """The JAX benchmark's GPT loss on ``(ids,)``: mean softmax
    cross-entropy of the f32 logits against ``roll(ids, -1)``."""
    (ids,) = batch
    logits = functional_call(model, variables, (ids,))
    targets = torch.roll(ids, -1, dims=-1)
    return F.cross_entropy(logits.flatten(0, -2), targets.flatten())


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """How to build one of the benchmark's models and what it trains on:
    ``make(dtype, generator, num_classes, num_filters)`` builds it,
    ``tokens`` says whether its batch is ``(ids,)`` (else ``(images,
    labels)``), ``loss`` is its per-rank loss, and ``images``, where set,
    fixes the image side, channels and classes (else ``--image-size``, 3
    channels and ``num_classes``)."""

    make: Callable[..., torch.nn.Module]
    loss: LossFn
    tokens: bool = False
    images: Optional[Tuple[int, int, int]] = None


def _resnet(cls):
    return lambda dtype, gen, classes, filters: cls(
        num_classes=classes, num_filters=filters, dtype=dtype, generator=gen)


def _gpt_small(dtype, gen, classes, filters):
    # the ResNets' widths; and, as in the JAX benchmark, GPT-small computes
    # in bf16 even under --fp32
    del dtype, classes, filters
    return TransformerLM(GPTConfig.small(), generator=gen)


def _lenet(dtype, gen, classes, filters):
    # as in the JAX benchmark: LeNet5() computes in f32 on 10 classes
    del dtype, classes, filters
    return LeNet5(generator=gen)


MODELS = {
    "lenet": ModelSpec(_lenet, image_loss, images=(28, 1, 10)),
    "resnet50": ModelSpec(_resnet(ResNet50), image_loss),
    "resnet18": ModelSpec(_resnet(ResNet18), image_loss),
    "gpt-small": ModelSpec(_gpt_small, lm_loss, tokens=True),
}
TOPOLOGIES = {"exp2": ExponentialTwoGraph, "ring": RingGraph,
              "grid": MeshGrid2DGraph}
COMMS = ("neighbor", "hierarchical", "allreduce", "winput", "none")


@dataclasses.dataclass
class Trainer:
    """``n`` virtual ranks of one model: rank-stacked parameters (leaf
    tensors with a stacked ``.grad``) and buffers (BatchNorm statistics; a
    GPT has none), a decentralized optimizer over the parameters, one fixed
    synthetic batch per rank (a tuple of rank-stacked tensors: NHWC images
    and integer labels, or token ids; None where every step is given its
    batch), and the model's per-rank loss."""

    model: torch.nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt: DecentralizedOptimizer
    batch: Optional[Tuple[torch.Tensor, ...]]
    loss_fn: LossFn

    @property
    def size(self) -> int:
        return next(iter(self.params.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def step(self, batch: Optional[Tuple[torch.Tensor, ...]] = None
             ) -> torch.Tensor:
        """One decentralized SGD step of every rank on ``batch`` (default:
        the trainer's fixed batch); returns the ``(n,)`` f32 losses (before
        the update).  One rank's activations are live at a time."""
        batch = self.batch if batch is None else batch
        losses = torch.empty(self.size, device=self.device)
        names = list(self.params)
        for r in range(self.size):
            p_r = {k: v[r] for k, v in self.params.items()}
            # rank r's row of the buffers, updated in place by BatchNorm
            b_r = {k: v[r] for k, v in self.buffers.items()}
            loss = self.loss_fn(self.model, (p_r, b_r),
                                tuple(t[r] for t in batch))
            grads = torch.autograd.grad(loss, list(p_r.values()))
            with torch.no_grad():
                for k, g in zip(names, grads):
                    self.params[k].grad[r].copy_(g)
                losses[r] = loss
        self.opt.step()
        return losses

    def state(self) -> Dict[str, torch.Tensor]:
        """Every tensor a step reads and writes: parameters, buffers, the
        optimizer's momentum and the optimizer's own tensors (with
        ``winput`` the window's self and landing buffers, under the names
        ``window.*``)."""
        out = {f"param.{k}": v for k, v in self.params.items()}
        out.update({f"buffer.{k}": v for k, v in self.buffers.items()})
        for k, v in self.params.items():
            buf = self.opt.state.get(v, {}).get("momentum_buffer")
            if buf is not None:
                out[f"momentum.{k}"] = buf
        out.update(self.opt.tensors())
        return out


def make_optimizer(base: torch.optim.Optimizer, comm: str = "neighbor",
                   topology: str = "exp2", size: int = 8,
                   local_size: int = 1) -> DecentralizedOptimizer:
    """The decentralized optimizer of one ``--comm`` flavor over ``base``
    (the JAX benchmark's ``build_optimizer``): ``hierarchical`` groups
    ``local_size`` ranks a machine on a ring of machines."""
    if comm == "neighbor":
        return DistributedNeighborAllreduceOptimizer(
            base, topology=TOPOLOGIES[topology](size))
    if comm == "hierarchical":
        if local_size <= 1 or size % local_size:
            raise ValueError("--comm hierarchical needs --local-size > 1 "
                             "dividing the number of ranks")
        return DistributedHierarchicalNeighborAllreduceOptimizer(
            base, machine_topology=RingGraph(size // local_size),
            local_size=local_size)
    if comm == "allreduce":
        return DistributedGradientAllreduceOptimizer(base)
    if comm == "winput":
        return DistributedWinPutOptimizer(
            base, topology=TOPOLOGIES[topology](size))
    if comm == "none":
        return decentralized_optimizer(
            base, None, communication_type=CommunicationType.empty)
    raise ValueError(f"unknown comm {comm!r}")


def build(model: str = "resnet50", comm: str = "neighbor",
          topology: str = "exp2", size: int = 8, batch_size: int = 32,
          image_size: int = 224, seq_len: int = 128, num_classes: int = 1000,
          num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
          seed: int = 0, device="cuda", local_size: int = 1) -> Trainer:
    """A :class:`Trainer` with the model's weights made from ``seed`` and
    copied to every rank, synthetic data from ``seed + 1`` (images and
    labels, or ``(size, batch_size, min(seq_len, max_position))`` token
    ids), and SGD with the JAX benchmark's lr 0.01 and momentum 0.9 under
    the ``comm`` flavor (:func:`make_optimizer`).  ``num_classes`` and
    ``num_filters`` shape the ResNets only."""
    dev = resolve_device(device)
    spec = MODELS[model]
    net = spec.make(dtype, torch.Generator().manual_seed(seed), num_classes,
                    num_filters).to(dev)
    params = rank_stack(dict(net.named_parameters()), size, dev)
    for p in params.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    buffers = rank_stack(dict(net.named_buffers()), size, dev)
    base = torch.optim.SGD(list(params.values()), lr=0.01, momentum=0.9)
    opt = make_optimizer(base, comm, topology, size, local_size)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if spec.tokens:
        cfg = net.cfg
        batch = (torch.randint(0, cfg.vocab_size,
                               (size, batch_size, min(seq_len,
                                                      cfg.max_position)),
                               generator=gen, device=dev),)
    else:
        side, channels, classes = spec.images or (image_size, 3, num_classes)
        batch = (torch.randn(size, batch_size, side, side, channels,
                             generator=gen, device=dev).to(dtype),
                 torch.randint(0, classes, (size, batch_size),
                               generator=gen, device=dev))
    return Trainer(net, params, buffers, opt, batch, spec.loss)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(trainer: Trainer, warmup: int, iters: int) -> Dict[str, object]:
    """``warmup`` untimed steps, then ``iters`` steps each timed on the host
    clock up to a device synchronize.  Returns the per-step losses
    (``(n,)`` numpy arrays), the timed steps' milliseconds, and samples
    (images or sequences) per second over all ranks."""
    dev = trainer.device
    losses: List[np.ndarray] = []
    step_ms: List[float] = []
    for i in range(warmup + iters):
        _sync(dev)
        t0 = time.perf_counter()
        loss = trainer.step()
        _sync(dev)
        if i >= warmup:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.cpu().numpy())
    samples = trainer.batch[0].shape[0] * trainer.batch[0].shape[1]
    rate = samples / (np.mean(step_ms) / 1e3) if step_ms else float("nan")
    return {"losses": losses, "step_ms": step_ms, "samples_per_s": rate}


def profile_step(trainer: Trainer, top: int = 10,
                 batch: Optional[Tuple[torch.Tensor, ...]] = None
                 ) -> Dict[str, object]:
    """One step (on ``batch``, default the trainer's) under
    ``torch.profiler`` (CUDA activity only, to keep the host's tracing cost
    out of the step): the step's losses and wall milliseconds,
    the device's busy milliseconds (the sum of the times of its kernels,
    copies and fills; one stream, so they do not overlap), its idle share,
    and the ``top`` of them by device time as ``(name, ms, count)``."""
    from torch.profiler import ProfilerActivity, profile

    dev = trainer.device
    if dev.type != "cuda":
        raise ValueError("profile_step measures the device; it needs cuda")
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        losses = trainer.step(batch)
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: Dict[str, List[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(
            e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(sum(ts) for ts in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]
    return {"losses": losses, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": len(kernels),
            "top": [(name, sum(ts), len(ts)) for name, ts in ranked]}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="resnet50")
    ap.add_argument("--comm", choices=COMMS, default="neighbor")
    ap.add_argument("--local-size", type=int, default=1,
                    help="ranks per machine (--comm hierarchical)")
    ap.add_argument("--topology", choices=sorted(TOPOLOGIES), default="exp2")
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--batch-size", type=int, default=32, help="per rank")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="tokens per sequence (gpt-small)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed steps, profile one more step on "
                         "the card: device busy time, idle share, top "
                         "kernels")
    args = ap.parse_args(argv)

    trainer = build(args.model, args.comm, args.topology, args.size,
                    args.batch_size, args.image_size, args.seq_len,
                    dtype=torch.float32 if args.fp32 else torch.bfloat16,
                    seed=args.seed, device=args.device,
                    local_size=args.local_size)
    res = run(trainer, args.warmup, args.iters)
    unit = "seq" if MODELS[args.model].tokens else "img"
    for i, ms in enumerate(res["step_ms"]):
        print(f"iter {i:3d}: {ms:.1f} ms/step, "
              f"{args.size * args.batch_size / ms * 1e3:,.1f} {unit}/s")
    print(f"\nmodel={args.model} comm={args.comm} topology={args.topology} "
          f"ranks={args.size} batch={args.batch_size} device={args.device}")
    print(f"{unit}/sec: {res['samples_per_s']:,.1f} over all ranks, "
          f"{res['samples_per_s'] / args.size:,.1f} per rank; final mean loss "
          f"{float(np.mean(res['losses'][-1])):.4f}")
    if args.profile:
        prof = profile_step(trainer)
        mean_ms = float(np.mean(res["step_ms"]))
        print(f"profiled step: {prof['wall_ms']:.2f} ms wall, "
              f"{prof['busy_ms']:.2f} ms on the device ({prof['kernels']} "
              f"kernels, copies and fills), device idle "
              f"{prof['idle_share']:.1%}; against the unprofiled mean step "
              f"of {mean_ms:.2f} ms, idle {1 - prof['busy_ms'] / mean_ms:.1%}")
        for name, ms, calls in prof["top"]:
            print(f"  {ms:9.3f} ms {calls:5d}x  {name[:100]}")
        res["profile"] = prof
    return res


if __name__ == "__main__":
    main()
