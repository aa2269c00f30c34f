"""The port stands alone: nothing under ``bluefog_tpu_torch/`` or in
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, and its entry
points run on the GPU unless the caller asks for the CPU."""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import bluefog_tpu_torch as pbf
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
