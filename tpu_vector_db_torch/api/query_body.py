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

``load`` builds the library (``ops/_build.py``) and loads it. The app
calls it at start-up; nothing is built when a module is imported or in a
request. Without a compiler it logs one warning and ``decode`` always
returns None.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
from pydantic import BaseModel

from tpu_vector_db_torch.ops._build import CSRC, Library


def _signatures(lib: ctypes.PyDLL) -> None:
    fn = lib.vdb_scan_vectors
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]


# PyDLL keeps the interpreter lock through the ~50 us call: released, a
# worker thread could take it and hold the event loop, which calls this,
# for up to a switch interval
LIBRARY = Library(CSRC / "query_body.cpp", _signatures, loader=ctypes.PyDLL)


def load() -> bool:
    """Build the library unless built, load it once a process; False (and
    one warning) when it cannot be built or loaded."""
    return LIBRARY.load() is not None


def decode(body: bytes, model_cls: type[BaseModel], field: str,
           rank: int) -> BaseModel | None:
    """``model_cls`` validated from the JSON ``body``, its ``field`` the
    float32 array of rank ``rank`` (1: ``(d,)``, 2: ``(rows, d)``) in place
    of a list; None for a body this path does not take whole (the library
    not loaded, a body the scanner leaves, the rest not valid JSON or not
    a valid request), which the generic path then decodes. ``field`` must
    have no validator beyond non-emptiness."""
    lib = LIBRARY.lib
    if lib is None:
        return None
    key = field.encode()
    cap = len(body) // 2 + 1   # a number and its comma take 2 bytes or more
    out = np.empty(cap, np.float32)
    info = (ctypes.c_int64 * 4)()
    n = lib.vdb_scan_vectors(body, len(body), key, len(key), rank,
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
