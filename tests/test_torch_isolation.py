"""The port stands alone: nothing under ``bluefog_tpu_torch/`` or in
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, and its entry
points run on the GPU unless the caller asks for the CPU."""

import ast
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import bluefog_tpu_torch as pbf
from bluefog_tpu_torch.data import loader as pload
from bluefog_tpu_torch.examples import imagenet_resnet as inet
from bluefog_tpu_torch.examples import mnist_decentralized as mnist
from bluefog_tpu_torch.examples import synthetic_benchmark as sb
from bluefog_tpu_torch.ops import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bluefog_tpu")


def _port_files():
    pkg = REPO / "bluefog_tpu_torch"
    files = sorted(p for p in pkg.rglob("*.py")
                   if "_build" not in p.relative_to(pkg).parts)
    return files + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom bluefog_tpu.ops import collectives\n"
                 "import bluefog_tpu_torch.ops\n")
    assert [m for m in _imported_modules(f)
            if m.split(".")[0] in FORBIDDEN] == ["bluefog_tpu.ops"]


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pbf.init(size=2)
        assert pbf.get_context().device.type == "cuda"
        pbf.shutdown()
        return
    with pytest.raises(RuntimeError, match="cuda"):
        pbf.init(size=8)
    assert not pbf.initialized()
    with pytest.raises(RuntimeError, match="cuda"):
        sb.build("resnet18", size=2, batch_size=1, image_size=32)
    with pytest.raises(RuntimeError, match="cuda"):
        sb.main(["--model", "resnet18", "--size", "2"])
    ctx = pbf.init(size=8, device="cpu")
    try:
        assert ctx.device.type == "cpu"
        assert pbf.size() == 8 and pbf.rank() == 0
        assert pbf.load_topology().name == "ExponentialTwoGraph"
        assert pbf.in_neighbor_ranks(0) == [4, 6, 7]
        assert pbf.out_neighbor_ranks(0) == [1, 2, 4]
        pbf.set_topology(pbf.topology.RingGraph(8))
        assert pbf.in_neighbor_ranks(3) == [2, 4]
        with pytest.raises(ValueError):
            pbf.set_topology(pbf.topology.RingGraph(4))
        pbf.set_topology(pbf.topology.MeshGrid2DGraph(8), is_weighted=False)
        assert pbf.get_context().schedule.size == 8
    finally:
        pbf.shutdown()
    with pytest.raises(RuntimeError, match="init"):
        pbf.size()


def test_host_sources_name_nothing_of_the_jax_package():
    """The port's host C++ sources, its own copies of ``tfrecord.cc`` and
    of the host runtime (engine, logging, timeline, window table) among
    them, refer to the port's files only (the CUDA kernels name the TPU
    kernel each one replaces)."""
    csrc = REPO / "bluefog_tpu_torch" / "csrc"
    sources = sorted([*csrc.glob("*.cc"), *csrc.glob("*.h")])
    assert [p.name for p in sources] == [
        "bf_runtime.h", "engine.cc", "logging.cc", "tfrecord.cc",
        "timeline.cc", "windows.cc"]
    # the port's shm segments carry a prefix of their own
    assert '"/bftwin_"' in (csrc / "windows.cc").read_text()
    bad = [f"{p.name}:{i}" for p in sources
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if re.search(r"bluefog_tpu(?!_torch)\b", line)]
    assert not bad, bad


def test_new_entry_points_default_to_cuda_and_raise_without_it():
    """The examples that read a data source, and the loader's device side,
    run on the GPU unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the examples run there for real")
    for main in (mnist.main, inet.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
        assert not pbf.initialized()
    with pytest.raises(RuntimeError, match="cuda"):
        mnist.build(size=2)
    with pytest.raises(RuntimeError, match="cuda"):
        pbf.init(size=8, local_size=2)
    ctx = pbf.init(size=8, local_size=2, device="cpu")
    try:
        loader = pload.DistributedLoader(
            pload.ArraySource(torch.zeros(16, 2).numpy()), 2)
        assert loader.device == ctx.device
    finally:
        pbf.shutdown()


def test_scan_covers_the_host_runtime():
    """The import scan above reaches the host runtime's modules, and none of
    them loads the JAX package's native library."""
    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for mod in ("runtime/native.py", "runtime/async_windows.py",
                "utils/timeline.py", "utils/logging.py", "utils/hostbuild.py",
                "sharding/gossip.py", "examples/async_pushsum.py",
                "examples/async_dsgd.py", "examples/async_dsgd_mp.py",
                "runtime/window_server.py", "runtime/wire_codec.py",
                "runtime/wire_status.py", "runtime/resilience.py",
                "runtime/membership.py", "runtime/ibfrun.py",
                "topology/mapping.py", "examples/elastic_membership.py"):
        assert f"bluefog_tpu_torch/{mod}" in files, mod
    text = (REPO / "bluefog_tpu_torch" / "runtime" / "native.py").read_text()
    assert "libbf_runtime" not in text


def test_async_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """The asynchronous examples put their models on the GPU unless the
    caller asks for the CPU (``--device cpu``)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the examples run there for real")
    from bluefog_tpu_torch.examples import async_dsgd, async_dsgd_mp

    with pytest.raises(RuntimeError, match="cuda"):
        async_dsgd.main(["--duration", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        async_dsgd_mp.main(["--worker", "0", "--bdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        async_dsgd_mp.main(["--worker", "0", "--bdir", str(tmp_path),
                            "--transport", "tcp", "--resilient"])
    assert not list(tmp_path.iterdir())  # raised before any rendezvous
    from bluefog_tpu_torch.examples import elastic_membership

    with pytest.raises(RuntimeError, match="cuda"):
        elastic_membership.main([])


def test_kernel_build_needs_nvcc():
    if _build.find_nvcc() is not None:
        return  # a toolkit is present: the build path is exercised on the card
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke runs for real there")
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_scan_covers_the_launcher_and_the_transport():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert {"bluefog_tpu_torch/runtime/launch.py",
            "bluefog_tpu_torch/ops/transport.py"} <= names


def test_launched_processes_default_to_the_card(tmp_path):
    """Under bfrun, ``init`` over the process group and the benchmark run on
    the GPU unless asked for the CPU: without one they raise, and the
    launcher exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the processes run there for real")
    script = tmp_path / "init.py"
    script.write_text(
        "import sys\n"
        "from bluefog_tpu_torch.runtime.launch import initialize_cluster\n"
        "initialize_cluster()\n"
        "import bluefog_tpu_torch as bf\n"
        "try:\n"
        "    bf.init(size=4)\n"
        "except RuntimeError as e:\n"
        "    assert 'cuda' in str(e), e\n"
        "    assert not bf.initialized()\n"
        "    ctx = bf.init(size=4, device='cpu')\n"
        "    assert (ctx.process_count, len(ctx.owned_ranks)) == (2, 2)\n"
        "    bf.shutdown()\n"
        "    sys.stdout.write('RAISED ON CUDA\\n')\n")
    env = dict(PYTHONPATH=str(REPO), PATH="/usr/bin:/bin",
               OMP_NUM_THREADS="1", HOME=str(tmp_path))
    bfrun = [sys.executable, "-m", "bluefog_tpu_torch.runtime.launch",
             "--no-build", "-np", "2"]
    res = subprocess.run(bfrun + [str(script)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("RAISED ON CUDA") == 2
    res = subprocess.run(
        bfrun + ["-m", "bluefog_tpu_torch.examples.synthetic_benchmark",
                 "--model", "resnet18", "--size", "2"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "cuda" in res.stderr


def test_scan_covers_chaos_control_and_metrics():
    """The import scan reaches every module of the chaos, control and
    metrics packages, and none of them imports JAX or the JAX package when
    loaded in a fresh interpreter."""
    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for mod in ("chaos/__init__.py", "chaos/spec.py", "chaos/injector.py",
                "chaos/cli.py", "chaos/__main__.py", "control/__init__.py",
                "control/plan.py", "control/evidence.py",
                "control/controller.py", "control/transport.py",
                "control/tree.py", "metrics/__init__.py",
                "metrics/health.py"):
        assert f"bluefog_tpu_torch/{mod}" in files, mod
    code = ("import sys\n"
            "import bluefog_tpu_torch.chaos, bluefog_tpu_torch.control\n"
            "import bluefog_tpu_torch.metrics.health\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(PYTHONPATH=str(REPO), PATH="/usr/bin:/bin"),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
