"""Build the port's host C++ libraries (no CUDA) at first use.

One helper for every host library of the port: ``csrc/tfrecord.cc``
(:mod:`bluefog_tpu_torch.data.tfrecord`) and the host runtime of
``csrc/{logging,timeline,engine,windows}.cc``
(:mod:`bluefog_tpu_torch.runtime.native`).  Each library lands in
``bluefog_tpu_torch/_build/`` under a name carrying a hash of the flags and
the sources, so an edited source is rebuilt and a stale library never
loaded.  Builds from several processes at once (xdist workers, the rank
processes of a run) serialise on an ``flock`` of the build directory itself
(no lock file is left behind), compile into a private temporary directory
and rename the result into place, so no process ever loads a half-written
file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["compiler", "library_path", "build_library"]


def compiler() -> Optional[str]:
    """The host C++ compiler: ``$CXX``, else ``g++``, ``c++`` or
    ``clang++`` from ``PATH``."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    return None


def library_path(build_dir: Path, stem: str, sources: Sequence[Path],
                 flags: Sequence[str],
                 headers: Sequence[Path] = ()) -> Path:
    """``build_dir/lib<stem>-<hash>.so``, the hash over the flags, the
    sources and the headers they include."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    return Path(build_dir) / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_library(build_dir: Path, stem: str, sources: Sequence[Path],
                  flags: Sequence[str], *, headers: Sequence[Path] = (),
                  link: Sequence[str] = ()) -> Path:
    """The library's path, compiled first when it is missing.  Raises
    ``RuntimeError`` without a compiler or when the compile fails."""
    build_dir = Path(build_dir)
    path = library_path(build_dir, stem, sources, flags, headers)
    if path.exists():
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(
            "no C++ compiler ($CXX, g++, c++, clang++) to build "
            + ", ".join(Path(s).name for s in sources))
    build_dir.mkdir(parents=True, exist_ok=True)
    fd = os.open(build_dir, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if path.exists():  # another process built it while we waited
            return path
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            out = Path(tmp) / path.name
            res = subprocess.run(
                [cxx, *flags, "-o", str(out), *map(str, sources), *link],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"building {path.name} failed ({res.returncode}):\n"
                    f"{res.stdout}{res.stderr}")
            os.replace(out, path)
        return path
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
