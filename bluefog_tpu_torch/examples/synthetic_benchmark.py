"""Synthetic throughput benchmark: decentralized SGD of a ResNet over ``n``
virtual ranks on one device.

Counterpart of ``examples/synthetic_benchmark.py`` of the JAX package for its
ResNet models and its ``neighbor``, ``winput`` and ``none`` communication
flavors.  Each rank holds its own copy of the model as a row of rank-stacked
parameters; a step runs every rank's forward and backward in turn on that
rank's batch, then one optimizer step: with ``neighbor``,
:func:`~bluefog_tpu_torch.optim.DistributedNeighborAllreduceOptimizer`, whose
gossip is one call of the kernel K1 per fused buffer; with ``winput``,
:func:`~bluefog_tpu_torch.optim.DistributedWinPutOptimizer`, whose put is one
call of the kernel K2 per dtype of the parameters.

BatchNorm runs in train mode with per-rank batch statistics that are not
gossiped, as in the JAX package's decentralized training step
(``__graft_entry__.py::dryrun_multichip``, ``examples/imagenet_resnet.py``);
the JAX benchmark instead freezes BatchNorm.

Run on the GPU (the default device; it raises without one)::

  python -m bluefog_tpu_torch.examples.synthetic_benchmark \\
      --model resnet50 --comm neighbor --topology exp2 --size 8

(``--comm winput`` for the one-sided window optimizer) and on the CPU at a
toy size::

  python -m bluefog_tpu_torch.examples.synthetic_benchmark --device cpu \\
      --model resnet18 --image-size 32 --batch-size 2 --size 4 --iters 2
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from bluefog_tpu_torch.models import ResNet18, ResNet50
from bluefog_tpu_torch.optim import (
    CommunicationType,
    DecentralizedOptimizer,
    DistributedNeighborAllreduceOptimizer,
    DistributedWinPutOptimizer,
    decentralized_optimizer,
)
from bluefog_tpu_torch.parallel.api import rank_stack
from bluefog_tpu_torch.parallel.context import resolve_device
from bluefog_tpu_torch.topology import ExponentialTwoGraph, RingGraph

__all__ = ["MODELS", "TOPOLOGIES", "Trainer", "build", "run",
           "profile_step", "main"]

MODELS = {"resnet50": ResNet50, "resnet18": ResNet18}
TOPOLOGIES = {"exp2": ExponentialTwoGraph, "ring": RingGraph}


@dataclasses.dataclass
class Trainer:
    """``n`` virtual ranks of one model: rank-stacked parameters (leaf
    tensors with a stacked ``.grad``) and BatchNorm buffers, a decentralized
    optimizer over the parameters, and one fixed synthetic batch per rank
    (NHWC images, integer labels)."""

    model: torch.nn.Module
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    opt: DecentralizedOptimizer
    images: torch.Tensor
    labels: torch.Tensor

    @property
    def size(self) -> int:
        return self.images.shape[0]

    def step(self) -> torch.Tensor:
        """One decentralized SGD step of every rank; returns the ``(n,)``
        f32 losses (before the update).  One rank's activations are live at
        a time."""
        losses = torch.empty(self.size, device=self.images.device)
        names = list(self.params)
        for r in range(self.size):
            p_r = {k: v[r] for k, v in self.params.items()}
            b_r = {k: v[r] for k, v in self.buffers.items()}
            # BatchNorm updates b_r in place: rank r's row of the buffers
            logits = functional_call(self.model, (p_r, b_r),
                                     (self.images[r],), {"train": True})
            loss = F.cross_entropy(logits, self.labels[r])
            grads = torch.autograd.grad(loss, list(p_r.values()))
            with torch.no_grad():
                for k, g in zip(names, grads):
                    self.params[k].grad[r].copy_(g)
                losses[r] = loss
        self.opt.step()
        return losses

    def state(self) -> Dict[str, torch.Tensor]:
        """Every tensor a step reads and writes: parameters, buffers, the
        optimizer's momentum and, with ``winput``, the window's self and
        landing buffers."""
        out = {f"param.{k}": v for k, v in self.params.items()}
        out.update({f"buffer.{k}": v for k, v in self.buffers.items()})
        for k, v in self.params.items():
            buf = self.opt.state.get(v, {}).get("momentum_buffer")
            if buf is not None:
                out[f"momentum.{k}"] = buf
        win = self.opt.window
        if win is not None:
            for dt, buf in win.bufs.items():
                out[f"window.self.{dt}"] = buf
                out[f"window.peers.{dt}"] = win.peers[dt]
        return out


def build(model: str = "resnet50", comm: str = "neighbor",
          topology: str = "exp2", size: int = 8, batch_size: int = 32,
          image_size: int = 224, num_classes: int = 1000,
          num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
          seed: int = 0, device="cuda") -> Trainer:
    """A :class:`Trainer` with the model's weights made from ``seed`` and
    copied to every rank, synthetic data from ``seed + 1``, and SGD with the
    JAX benchmark's lr 0.01 and momentum 0.9."""
    dev = resolve_device(device)
    net = MODELS[model](num_classes=num_classes, num_filters=num_filters,
                        dtype=dtype,
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    params = rank_stack(dict(net.named_parameters()), size, dev)
    for p in params.values():
        p.requires_grad_(True)
        p.grad = torch.zeros_like(p)
    buffers = rank_stack(dict(net.named_buffers()), size, dev)
    base = torch.optim.SGD(list(params.values()), lr=0.01, momentum=0.9)
    if comm == "neighbor":
        opt = DistributedNeighborAllreduceOptimizer(
            base, topology=TOPOLOGIES[topology](size))
    elif comm == "winput":
        opt = DistributedWinPutOptimizer(
            base, topology=TOPOLOGIES[topology](size))
    elif comm == "none":
        opt = decentralized_optimizer(
            base, None, communication_type=CommunicationType.empty)
    else:
        raise ValueError(f"unknown comm {comm!r}")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    images = torch.randn(size, batch_size, image_size, image_size, 3,
                         generator=gen, device=dev).to(dtype)
    labels = torch.randint(0, num_classes, (size, batch_size), generator=gen,
                           device=dev)
    return Trainer(net, params, buffers, opt, images, labels)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(trainer: Trainer, warmup: int, iters: int) -> Dict[str, object]:
    """``warmup`` untimed steps, then ``iters`` steps each timed on the host
    clock up to a device synchronize.  Returns the per-step losses
    (``(n,)`` numpy arrays), the timed steps' milliseconds, and images per
    second over all ranks."""
    dev = trainer.images.device
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
    images = trainer.images.shape[0] * trainer.images.shape[1]
    rate = images / (np.mean(step_ms) / 1e3) if step_ms else float("nan")
    return {"losses": losses, "step_ms": step_ms, "img_per_s": rate}


def profile_step(trainer: Trainer, top: int = 10) -> Dict[str, object]:
    """One step under ``torch.profiler`` (CUDA activity only, to keep the
    host's tracing cost out of the step): the step's wall milliseconds,
    the device's busy milliseconds (the sum of the times of its kernels,
    copies and fills; one stream, so they do not overlap), its idle share,
    and the ``top`` of them by device time as ``(name, ms, count)``."""
    from torch.profiler import ProfilerActivity, profile

    dev = trainer.images.device
    if dev.type != "cuda":
        raise ValueError("profile_step measures the device; it needs cuda")
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step()
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
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": len(kernels),
            "top": [(name, sum(ts), len(ts)) for name, ts in ranked]}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="resnet50")
    ap.add_argument("--comm", choices=["neighbor", "winput", "none"],
                    default="neighbor")
    ap.add_argument("--topology", choices=sorted(TOPOLOGIES), default="exp2")
    ap.add_argument("--size", type=int, default=8, help="virtual ranks")
    ap.add_argument("--batch-size", type=int, default=32, help="per rank")
    ap.add_argument("--image-size", type=int, default=224)
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
                    args.batch_size, args.image_size,
                    dtype=torch.float32 if args.fp32 else torch.bfloat16,
                    seed=args.seed, device=args.device)
    res = run(trainer, args.warmup, args.iters)
    for i, ms in enumerate(res["step_ms"]):
        print(f"iter {i:3d}: {ms:.1f} ms/step, "
              f"{args.size * args.batch_size / ms * 1e3:,.1f} img/s")
    print(f"\nmodel={args.model} comm={args.comm} topology={args.topology} "
          f"ranks={args.size} batch={args.batch_size} device={args.device}")
    print(f"img/sec: {res['img_per_s']:,.1f} over all ranks, "
          f"{res['img_per_s'] / args.size:,.1f} per rank; final mean loss "
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
