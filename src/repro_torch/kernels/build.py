"""Build the hand-written CUDA kernels of ``<name>/csrc/*.cu`` with ``nvcc``.

At first use each kernel package is compiled for ``sm_90a`` into a shared
library with a plain C interface, under ``build/repro_torch/<name>-<hash>/``
at the repository root, and loaded with ``ctypes`` by the package.  The
sources may include the headers of ``kernels/csrc/`` (``hopper.cuh``: TMA,
mbarriers, wgmma), which nvcc finds through ``-I``.  The hash covers the
flags, the package's ``*.cu`` and ``*.cuh`` and those shared headers
(``library_path``), so an edit to any of them builds a new library.  There
is no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: Headers shared by the kernel packages, passed to nvcc as ``-I``.
INCLUDE = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: What the last build of each package did: library path, seconds and the
#: compiler's output (``-Xptxas -v``: registers, shared memory, spills),
#: which a cached build reads back from beside its library.
build_info: Dict[str, Dict[str, object]] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def library_path(name: str, csrc: Path, include: Path = INCLUDE) -> Path:
    """Where the library of ``csrc`` builds: a hash of the flags, of
    ``csrc``'s ``*.cu`` and ``*.cuh`` and of ``include``'s ``*.cuh``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(Path(csrc).glob("*.cu")) + \
            sorted(Path(csrc).glob("*.cuh")) + \
            sorted(Path(include).glob("*.cuh")):
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str, csrc: Path, include: Path = INCLUDE) -> Path:
    """Compile one kernel package (once per source hash) and return the
    library's path."""
    sources = sorted(Path(csrc).glob("*.cu"))
    lib = library_path(name, csrc, include)
    log = lib.with_name("nvcc.log")
    if lib.exists():
        build_info[name] = dict(path=str(lib), seconds=0.0,
                                log=log.read_text() if log.exists()
                                else "(cached)")
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"lib{name}.{os.getpid()}.so")
    t = time.perf_counter()
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, f"-I{include}", "-o", str(tmp),
         *map(str, sources)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, lib)
    build_info[name] = dict(path=str(lib), seconds=time.perf_counter() - t,
                            log=proc.stdout)
    return lib
