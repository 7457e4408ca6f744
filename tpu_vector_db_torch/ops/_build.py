"""Build and load the package's CUDA kernels.

The sources under ``tpu_vector_db_torch/csrc/`` (``flat_topk.cu``,
``ivf_topk.cu``, and the header they share) expose a plain C interface.
At first use each ``.cu`` is compiled with ``nvcc`` for ``sm_90a`` into
``tpu_vector_db_torch/_build/`` (one shared library per source, named by
a hash of its content, so an edited source rebuilds) and loaded with
``ctypes``. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (the hash
    covers the source, the shared headers and the flags)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str, extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    library path and the compiler's output (empty when nothing was
    built). Raises RuntimeError with the compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
