"""The kernel library's name hashes every file the kernels compile from.

``ops/_build.py`` names the built library by a hash of the nvcc flags and
the sources, so that an edited file is rebuilt and a stale library is never
loaded.  The bf16 K3 sources share their wgmma helpers through a header, so
the hash must cover the headers as well.  This needs no ``nvcc``: it works
on a copy of ``csrc/``.
"""

import re
import shutil

from bluefog_tpu_torch.ops import _build


def _copy_csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, src)
    monkeypatch.setattr(_build, "_CSRC", src)
    return src


def test_every_local_include_is_a_hashed_file_of_csrc():
    """Every header a source includes lies beside it, with a suffix the
    hash covers."""
    for cu in _build._sources():
        for name in re.findall(r'#include\s+"([^"]+)"', cu.read_text()):
            assert (_build._CSRC / name).is_file(), (cu.name, name)
            assert name.endswith(".cuh"), (cu.name, name)


def test_editing_the_shared_header_changes_the_library_path(tmp_path,
                                                            monkeypatch):
    src = _copy_csrc(tmp_path, monkeypatch)
    first = _build._library_path()
    assert _build._library_path() == first
    assert first.parent == _build._BUILD_DIR
    header = src / "flash_wgmma.cuh"
    assert any('#include "flash_wgmma.cuh"' in cu.read_text()
               for cu in _build._sources())
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build._library_path()
    assert second != first
    # a source edit moves it again; only the .cu files are compiled
    cu = src / "flash_attention.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    assert _build._library_path() not in (first, second)
    assert [p.suffix for p in _build._sources()] == [".cu"] * 4
