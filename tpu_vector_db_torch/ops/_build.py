"""Build and load the port's compiled libraries.

Each native library is declared once as a ``Library`` and built and loaded
here at its first ``load()``, never at import. The source's directory sets
where the library goes and its name, a hash of the content (git keeps no
mtimes):

* ``tpu_vector_db_torch/csrc/``: kernels (``*.cu``, nvcc for ``sm_90a``)
  and host code (``*.cpp``, g++) into ``_build/lib<stem>_<hash>.so``, the
  hash covering the source, the shared headers and the flags.
* ``native/`` at the repository root: the C++ bridges the JAX package
  shares, built as its loader builds them into
  ``native/<name>-<sha256(source)[:12]>.so`` (``-march=native`` tried
  first, older builds removed), so that both packages load one file.

A build goes to a temporary file renamed into place, so no process loads
a library another one is still writing. A kernel that does not build
raises with the compiler's output; a host library logs one warning a
process, and its callers take their other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NATIVE_DIR = _PKG.parent / "native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# never -ffast-math: linking crtfastmath.o sets the process's flush-to-zero
# flags on dlopen, which would change how float32 subnormals are cast
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_NATIVE_ARCH = ("-march=native", "-ffp-contract=fast")
_GXX_TIMEOUT_S = 300


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def _compile(cmd: list[str], source: Path, out: Path,
             timeout: float | None = _GXX_TIMEOUT_S) -> str:
    """Run ``cmd -o <temporary> source`` and move the result to ``out``.
    Returns the compiler's output; raises RuntimeError with it when the
    compiler fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp), str(source)],
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cmd[0]).name} failed ({proc.returncode}) for "
                f"{source.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return proc.stdout + proc.stderr


def _package_build(source: Path, out_dir: Path, name: str,
                   extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """A ``csrc/`` source's library, built unless built, and the
    compiler's output (empty when nothing was built)."""
    nvcc = source.suffix == ".cu"
    flags = NVCC_FLAGS if nvcc else GXX_FLAGS
    blob = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(blob + " ".join(flags).encode()).hexdigest()
    out = out_dir / f"{name}_{digest[:12]}.so"
    if out.exists():
        return out, ""
    if nvcc:
        return out, _compile([nvcc_path(), *flags, *extra_flags], source,
                             out, timeout=None)
    return out, _compile(["g++", *flags, *extra_flags], source, out)


def _shared_build(source: Path, out_dir: Path, name: str,
                  flags: tuple[str, ...]) -> Path:
    """A ``native/`` source's library, built unless built."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    out = out_dir / f"{name}-{digest}.so"
    if out.exists():
        return out
    try:
        _compile(["g++", *_NATIVE_ARCH, *GXX_FLAGS, *flags], source, out)
    except (RuntimeError, subprocess.SubprocessError):
        _compile(["g++", *GXX_FLAGS, *flags], source, out)
    for old in out_dir.glob(f"{name}-*.so"):
        if old != out:
            old.unlink(missing_ok=True)
    return out


def build(name: str, extra_flags: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists (``extra_flags``
    do not enter its name). Returns the library path and the compiler's
    output (empty when nothing was built). Raises RuntimeError with the
    compiler's output on failure."""
    return _package_build(CSRC / f"{name}.cu", BUILD_DIR, f"lib{name}",
                          extra_flags)


class Library:
    """One compiled library, loaded once a process: ``register`` sets its
    ctypes signatures after the load, ``loader`` is ``ctypes.CDLL`` or
    ``ctypes.PyDLL`` (the call keeps the interpreter lock). It is built
    into ``out_dir`` under ``name`` (default ``lib<stem>``), ``flags``
    added to the compiler's."""

    def __init__(self, source: Path,
                 register: Callable[[ctypes.CDLL], None], *,
                 name: str | None = None, flags: tuple[str, ...] = (),
                 loader: type[ctypes.CDLL] = ctypes.CDLL) -> None:
        self.source = source
        self._shared = source.parent == NATIVE_DIR
        self.out_dir = source.parent if self._shared else BUILD_DIR
        self.name = name or f"lib{source.stem}"
        self.lib: ctypes.CDLL | None = None   # set once loaded
        self._flags = flags
        self._register = register
        self._loader = loader
        self._lock = threading.Lock()
        self._failed = False

    def load(self) -> ctypes.CDLL | None:
        """The library, built and loaded at the first call. A host library
        that cannot be gives None from then on, after one warning; a
        kernel raises, at every call."""
        with self._lock:
            if self.lib is None and not self._failed:
                try:
                    path = (_shared_build(self.source, self.out_dir,
                                          self.name, self._flags)
                            if self._shared else _package_build(
                                self.source, self.out_dir, self.name,
                                self._flags)[0])
                    lib = self._loader(str(path))
                except (OSError, RuntimeError,
                        subprocess.SubprocessError) as exc:
                    if self.source.suffix == ".cu":
                        raise
                    self._failed = True
                    logger.warning("%s is not available, its callers take "
                                   "their other path: %s", self.source.name,
                                   exc)
                    return None
                self._register(lib)
                self.lib = lib
            return self.lib
