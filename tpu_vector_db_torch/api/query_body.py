"""Decode a query request's body with its vectors parsed in compiled code.

``csrc/query_body.cpp`` (a plain C interface, host code) finds the
request's vector member (``query`` or ``queries``) and parses its numbers
straight into a float32 array, bit-equal to
``np.asarray(json.loads(body)[field], np.float32)``. The rest of the body,
a few dozen bytes, still goes through ``json.loads`` and the request
model's validation, with the vector's value replaced by a placeholder.
``decode`` returns None for any body it does not take whole, and the
caller then runs the generic path, whose statuses and reasons stay those
of every body.

``load`` builds the library with ``g++`` into ``tpu_vector_db_torch/_build/``
(named by a hash of the source and the flags, so an edited source
rebuilds) and loads it with ``ctypes``. The app calls it at start-up;
nothing is built when a module is imported or in a request. Without a
compiler it logs one warning and ``decode`` always returns None.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
from pydantic import BaseModel

from tpu_vector_db_torch.ops._build import BUILD_DIR, CSRC

logger = logging.getLogger(__name__)

SOURCE = CSRC / "query_body.cpp"
# never -ffast-math: its start-up code sets the process's flush-to-zero
# flags, which would change how float32 subnormals are cast
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.PyDLL | None = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libquery_body_{digest[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) for "
                           f"{SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> bool:
    """Build the library unless built, load it once a process; False (and
    one warning) when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                path = library_path()
                if not path.exists():
                    _build(path)
                # PyDLL keeps the interpreter lock through the ~50 us call:
                # released, a worker thread could take it and hold the
                # event loop, which calls this, for up to a switch interval
                lib = ctypes.PyDLL(str(path))
                fn = lib.vdb_scan_vectors
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                               ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_int64)]
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
                logger.warning(
                    "query bodies decode on the generic path: %s", exc)
        return _lib is not None


def decode(body: bytes, model_cls: type[BaseModel], field: str,
           rank: int) -> BaseModel | None:
    """``model_cls`` validated from the JSON ``body``, its ``field`` the
    float32 array of rank ``rank`` (1: ``(d,)``, 2: ``(rows, d)``) in place
    of a list; None for a body this path does not take whole (the library
    not loaded, a body the scanner leaves, the rest not valid JSON or not
    a valid request), which the generic path then decodes. ``field`` must
    have no validator beyond non-emptiness."""
    if _lib is None:
        return None
    key = field.encode()
    cap = len(body) // 2 + 1   # a number and its comma take 2 bytes or more
    out = np.empty(cap, np.float32)
    info = (ctypes.c_int64 * 4)()
    n = _lib.vdb_scan_vectors(body, len(body), key, len(key), rank,
                              out.ctypes.data, cap, info)
    if n <= 0:
        return None
    start, stop, rows, cols = info
    try:
        payload = json.loads(
            (body[:start] + b"0" + body[stop:]).decode("utf-8"))
        payload[field] = [0.0] if rank == 1 else [[0.0]]
        model = model_cls.model_validate(payload)
    except (ValueError, RecursionError):   # the generic path's to answer
        return None
    setattr(model, field, out[:n] if rank == 1
            else out[:n].reshape(rows, cols))
    return model
