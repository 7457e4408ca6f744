"""Shared ctypes loader for the in-tree C++ bridges (``native/*.cpp``).

Counterpart of ``tpu_vector_db/pipeline/_native.py``, with the same
content, so that both packages build a source to the same library:
``native/<stem>-<sha256[:12]>.so`` at the repository root.

Staleness is keyed on a CONTENT HASH of the source, not mtimes: git does
not preserve mtimes, so after a clone an mtime check could load a stale
binary instead of compiling the source. Binaries are never committed
(``.gitignore`` lists ``native/*.so``) and a hash mismatch always
recompiles. The compiler writes a temporary file that is renamed into
place, so a process never loads a library another one is still writing.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Sequence

logger = logging.getLogger(__name__)

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"


class NativeLib:
    """Lazily compiled + loaded shared object with ctypes signatures.

    register(lib) sets argtypes/restypes once after the first CDLL load.
    extra_flags append to the g++ invocation (e.g. -fopenmp-simd for the
    graph builder's distance loops). -march=native is attempted first and
    dropped for compilers/targets that reject it. A missing compiler
    degrades to None (callers keep another path).
    """

    def __init__(self, src_name: str, lib_name: str,
                 register: Callable[[ctypes.CDLL], None],
                 extra_flags: Sequence[str] = ()) -> None:
        self._src = NATIVE_DIR / src_name
        self._stem = lib_name[:-3] if lib_name.endswith(".so") else lib_name
        self._register = register
        self._extra = list(extra_flags)
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._tried = False

    def _compile(self, lib_path: Path) -> bool:
        base = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                *self._extra, str(self._src), "-o", str(lib_path)]
        # NOT -ffast-math: linking crtfastmath.o flips the process-wide
        # FTZ/DAZ flags on dlopen
        last: Exception | None = None
        for arch in (["-march=native", "-ffp-contract=fast"], []):
            try:
                subprocess.run(base[:2] + arch + base[2:], check=True,
                               capture_output=True, timeout=120)
                return True
            except (subprocess.SubprocessError, FileNotFoundError) as exc:
                last = exc
        logger.warning("native %s unavailable (%s)", self._src.name, last)
        return False

    def load(self) -> ctypes.CDLL | None:
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            if not self._src.exists():
                return None
            digest = hashlib.sha256(self._src.read_bytes()).hexdigest()[:12]
            lib_path = self._src.parent / f"{self._stem}-{digest}.so"
            if not lib_path.exists():
                tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
                if not self._compile(tmp):
                    tmp.unlink(missing_ok=True)
                    return None
                os.replace(tmp, lib_path)
                # drop builds of older source revisions
                for old in self._src.parent.glob(f"{self._stem}-*.so"):
                    if old != lib_path:
                        old.unlink(missing_ok=True)
            lib = ctypes.CDLL(str(lib_path))
            self._register(lib)
            self._lib = lib
            return lib
