"""Build the port's CUDA C++ sources with ``nvcc`` and load them by ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface -- no PyTorch headers, so a build takes seconds, not
minutes. Libraries go under the repository's ``build/kernels/`` (ignored by
git), named by a hash of the sources and flags, and are built at first use:
a fresh checkout on a machine with a GPU builds them from the repository's
own sources. Without ``nvcc`` a build raises; nothing falls back.

The flags target Hopper (``sm_90a``) and leave fast math off: the kernels
rely on the subnormal constant 1e-38 surviving (no flush to zero).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "NVCC_FLAGS", "find_nvcc", "library_path", "build",
           "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: the kernel sources, ``csrc/<name>.cu``
SOURCES = ("edge_prelude", "fused_update_e", "fused_update_t")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc`` (``PATH``, then ``$CUDA_HOME/bin``, then the
    toolkit's default prefix); raises ``RuntimeError`` when there is none."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels of repro_torch "
                       "are built from source at first use and need the CUDA "
                       "toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed on a hash of every source
    in ``csrc/`` and the flags, so an edit rebuilds and a rerun reuses."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together, and wait for them. Returns ``{name: the
    compiler's ptxas report}`` for the sources built by this call. Raises
    ``RuntimeError`` with the compiler output when a build fails."""
    nvcc = None
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            nvcc = nvcc or find_nvcc()
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        reports, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
                continue
            os.replace(tmp, out)
            reports[name] = text
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
