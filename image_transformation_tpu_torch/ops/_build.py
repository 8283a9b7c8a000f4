"""Build and load the port's hand-written CUDA kernels.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package into one
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/kernels_<hash>.so csrc/*.cu

The file is named by a hash of the sources and flags, under ``build/kernels/``
at the root of the checkout, so an unchanged tree builds once and an edited
source builds anew. The library is loaded with ``ctypes``; each wrapper sets
its entry's argument types (pointers and the stream as ``c_void_p``).

Nothing is built when this module is imported: the CPU tests import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last build took in this process (0.0 when the .so existed)
last_build_seconds = 0.0


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from csrc/*.cu on first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu unless the hashed library exists; returns its path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills of each kernel)."""
    global last_build_seconds
    out = library_path()
    if out.is_file():
        last_build_seconds = 0.0
        return out
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build(verbose=verbose)))
    return _LIB
