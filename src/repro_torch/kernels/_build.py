"""Build the port's CUDA kernels with ``nvcc`` at first use.

Every ``csrc/*.cu`` under ``repro_torch/kernels/`` is compiled for
``sm_90a`` (one ``nvcc`` process per source, all started together) and
linked into one shared library with a plain C interface, which the kernels'
``kernel.py`` modules bind with ``ctypes``.  The library lands in
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--ptxas-options=-v", "-Xcompiler", "-fPIC")


def sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the one
    on PATH, else None."""
    path = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    return str(path) if path.exists() else shutil.which("nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprokernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Start every command at once; return their outputs, or raise with the
    command line and output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> Path:
    """Compile and link the kernels unless the library for these sources
    exists; returns its path.  The compiler's register and shared-memory
    report (``--ptxas-options=-v``) is kept beside it as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    exe = nvcc()
    if exe is None:
        cmd = ["nvcc", *NVCC_FLAGS, "-c", str(sources()[0])]
        raise RuntimeError(
            f"nvcc not found under $CUDA_HOME/bin, /usr/local/cuda/bin or on "
            f"PATH; the kernels build only where the CUDA toolkit is "
            f"installed, with: {' '.join(cmd)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{i}_{src.stem}.o" for i, src in enumerate(sources())]
        logs = _run_all([[exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(sources(), objs)])
        lib = Path(tmp) / out.name
        _run_all([[exe, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(lib)]])
        Path(tmp, "build.log").write_text("".join(logs))
        os.replace(Path(tmp, "build.log"), out.with_suffix(".log"))
        os.replace(lib, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(str(build()))
