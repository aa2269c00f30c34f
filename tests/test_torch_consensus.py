"""The port's consensus examples, run on the CPU.

``examples.average_consensus`` on its five topologies, ``examples.choco_sgd``
with both compressors, and ``examples.convergence_comparison`` at a cut size
(96 examples per rank, batches of 8, 6 epochs: 72 steps a flavor, where the
JAX example's defaults take 96 steps of 32), each through its ``main`` as a
user would call it, holding each to the example's own asserts (it raises
where the JAX example asserts) and to its printed ``OK``.
"""

import numpy as np
import pytest
import torch

import bluefog_tpu_torch.topology as pt
from bluefog_tpu_torch.examples import average_consensus, choco_sgd
from bluefog_tpu_torch.examples import convergence_comparison

N = 8


@pytest.fixture(autouse=True, scope="module")
def _pinned_torch_threads():
    """One torch thread: parallel workers would oversubscribe the host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def comparison():
    """``convergence_comparison`` at the cut size, run once for the module
    (its four LeNet trainings take seconds on one thread)."""
    return convergence_comparison.main([
        "--device", "cpu", "--epochs", "6", "--n-per-rank", "96",
        "--batch", "8"])


@pytest.mark.parametrize("topology",
                         sorted(average_consensus.TOPOLOGIES))
def test_average_consensus(topology, capsys):
    res = average_consensus.main(["--device", "cpu", "--size", str(N),
                                  "--dim", "64", "--topology", topology])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and res["err"] < 1e-3
    assert "final consensus error" in out


def test_consensus_weights_are_the_left_perron_vector():
    """Uniform for the doubly stochastic graphs; for the star, ``pi W =
    pi`` with the centre weighted by its larger self weight."""
    for name in ("exp2", "ring", "grid", "full"):
        w = average_consensus.TOPOLOGIES[name](N).weights
        np.testing.assert_allclose(average_consensus.consensus_weights(w),
                                   np.full(N, 1 / N), atol=1e-12)
    w = pt.StarGraph(N).weights
    pi = average_consensus.consensus_weights(w)
    np.testing.assert_allclose(pi @ w, pi, atol=1e-12)
    assert abs(pi.sum() - 1) < 1e-12 and pi[0] > pi[1]


@pytest.mark.parametrize("compressor", ["random_block_k", "top_k"])
def test_choco_sgd(compressor, capsys):
    res = choco_sgd.main(["--device", "cpu", "--compressor", compressor])
    assert capsys.readouterr().out.rstrip().endswith("OK")
    assert res["err"] < 0.05 and res["spread"] < 0.01


def test_choco_sgd_raises_when_short_of_the_optimum():
    with pytest.raises(RuntimeError, match="shared optimum"):
        choco_sgd.main(["--device", "cpu", "--steps", "20"])


def test_convergence_comparison(comparison):
    """Gossip within the stated gaps of allreduce, the isolated ranks
    behind it (what ``main`` asserts), and every flavor above chance."""
    acc = comparison["acc"]
    assert acc["allreduce"] - acc["exp2 gossip"] <= 0.05
    assert acc["allreduce"] - acc["ring gossip"] <= 0.08
    assert acc["no comm"] < acc["allreduce"]
    assert min(acc.values()) > 0.1


def test_examples_default_to_the_card():
    """Without ``--device cpu`` each example asks for CUDA, which this host
    lacks: it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (average_consensus.main, choco_sgd.main,
                 convergence_comparison.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
