"""``bluefog_tpu_torch/utils/inspect.py``: the host-side census of what a
step communicated, and ``compiled_flops``.

The JAX package counts collective instructions in a compiled program's
HLO; the port counts, while one step runs, its collective calls and each
kernel wrapper's calls and launches.  A small ResNet step on the CPU is
held against its fuse plan: one gossip call, one K1 wrapper call per fused
buffer, no launch (a CPU tensor runs the plain version)."""

import torch

from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.ops.collectives import fuse_plan
from bluefog_tpu_torch.utils import inspect as BI


def test_census_of_a_resnet_step_matches_its_fuse_plan():
    trainer = sb.build("resnet18", "neighbor", "ring", size=2, batch_size=1,
                       image_size=32, num_classes=10, num_filters=4,
                       dtype=torch.float32, device="cpu")
    groups, big = fuse_plan(list(trainer.params.values()))
    census = BI.collective_census(trainer.step)
    assert census["calls"] == {"neighbor_allreduce": 1}
    assert census["kernels"] == {
        "gossip_mix": {"calls": len(groups) + len(big), "launches": 0}}
    assert census["axes"] == {}
    # a window put: one put call, one K2 wrapper call per dtype buffer
    winput = sb.build("resnet18", "winput", "ring", size=2, batch_size=1,
                      image_size=32, num_classes=10, num_filters=4,
                      dtype=torch.float32, device="cpu")
    census = BI.collective_census(winput.step)
    assert census["calls"].get("win_put") == 1
    assert census["kernels"]["window_deliver"] == {"calls": 1,
                                                   "launches": 0}


def test_compiled_flops_of_a_matmul():
    m, k, n = 8, 16, 4
    a, b = torch.randn(m, k), torch.randn(k, n)
    assert BI.compiled_flops(torch.matmul, a, b) == 2 * m * n * k


def test_kernel_counters_name_every_wrapper():
    counters = BI.kernel_counters()
    assert set(counters) == {
        "gossip_mix", "gossip_mix_peer", "window_deliver",
        "window_deliver_peer", "flash_forward", "flash_backward_dkv",
        "flash_backward_dq"}
    assert all(set(c) == {"calls", "launches"} for c in counters.values())
