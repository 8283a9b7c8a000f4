"""Build and load the port's hand-written CUDA kernels.

On first use, ``nvcc`` compiles every ``csrc/*.cu`` of this package into one
shared library with a plain C interface: one ``nvcc -c`` per source, all
started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu    (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o <build dir>/kernels_<hash>.so <tmp>/*.o

The file is named by a hash of the sources, headers and flags, so an
unchanged tree builds once and an edited source builds anew. It goes under
:func:`build_dir`: ``build/kernels/`` at the root of a source checkout, and
``~/.cache/image_transformation_tpu_torch/kernels/`` for an installed
package. The library is loaded with ``ctypes``; each wrapper sets its
entry's argument types (pointers and the stream as ``c_void_p``).

Nothing is built when this module is imported: the CPU tests import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_LIB: Optional[ctypes.CDLL] = None
#: held while the library is built and loaded: the threaded server's first
#: concurrent requests run nvcc once, and every other thread waits for it
_LIB_LOCK = threading.Lock()
#: seconds the last build took in this process (0.0 when the .so existed)
last_build_seconds = 0.0
#: ptxas's report of the last verbose build in this process ("" otherwise)
last_build_report = ""


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    """Where the library is built: ``build/kernels`` at the root of a source
    checkout (the directory above the package holds a ``pyproject.toml``),
    else the user's cache, beside the serving manifest."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    return Path.home() / ".cache" / "image_transformation_tpu_torch" / "kernels"


def check_includes() -> None:
    """Raise, naming the file, when a source or header includes a local
    header that ``csrc/`` lacks (an install that left the headers out),
    before nvcc reports it as a bare include error."""
    missing = []
    for src in sorted([*sources(), *CSRC_DIR.glob("*.cuh")]):
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', src.read_text(), re.M):
            if not (CSRC_DIR / name).is_file():
                missing.append(f"{src.name} includes {name}")
    if missing:
        raise RuntimeError(
            f"CUDA headers missing under {CSRC_DIR}: {'; '.join(missing)} "
            "(the package must ship csrc/*.cuh with csrc/*.cu)"
        )


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
    for src in sorted([*sources(), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu unless the hashed library exists; returns its path.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report
    (registers, shared memory and spills of each kernel)."""
    global last_build_seconds, last_build_report
    out = library_path()
    if out.is_file():
        last_build_seconds = 0.0
        return out
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    check_includes()
    out_dir = out.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    verbose_flags = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as objdir:
        objs = [Path(objdir) / f"{src.stem}.o" for src in srcs]
        procs = [
            (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *verbose_flags, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ), src)
            for src, obj in zip(srcs, objs)
        ]
        failed, reports = [], []
        for proc, src in procs:
            _, err = proc.communicate()
            reports.append(err)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}"
            )
    last_build_seconds = time.perf_counter() - t0
    if verbose:
        last_build_report = "".join(reports)
        print(last_build_report, end="")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def ptxas_usage(report: str) -> dict:
    """Per kernel of a ``-Xptxas -v`` report: {mangled name: dict(registers,
    smem (static bytes), stack, spill_stores, spill_loads)}."""
    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = dict(registers=0, smem=0, stack=0, spill_stores=0, spill_loads=0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[name]["smem"] = int(m.group(1)) if m else 0
    return usage


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library, once per
    process, whichever thread asks first."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(str(build(verbose=verbose)))
        return _LIB
