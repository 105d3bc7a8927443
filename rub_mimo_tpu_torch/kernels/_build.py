"""Build and load the package's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``rub_mimo_tpu_torch/_build/<name>-<hash>.so`` (the hash covers the
source, every shared header ``csrc/*.cuh`` and the flags, so an edit to
either rebuilds) and loaded with ctypes.  ``build_all`` compiles several
sources at once, one nvcc each.  Only sources in this package are built.
Nothing here runs at import: the package imports on machines without nvcc
or a GPU.  A library's load is a set-up span ``setup.kernel_load`` (its
name the span's detail; nvcc's build, where it runs, inside it;
utils/profiling.py).
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

from rub_mimo_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "kernels" / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (PATH or $CUDA_HOME/bin)")


def library_path(name: str) -> Path:
    """Where the built library for csrc/<name>.cu lives."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> list:
    """Compile each csrc/<name>.cu that is not built yet, all nvcc
    processes at once; return the libraries' paths.  The compiler's
    report (registers, shared memory, spills) is kept beside each library
    as <library>.log.  Raises if any build fails."""
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        Path(str(out) + ".log").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the same source is already built."""
    return build_all([name])[0]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library."""
    with profiling.setup_span("setup.kernel_load", name):
        return ctypes.CDLL(str(build(name)))
