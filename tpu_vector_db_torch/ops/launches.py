"""Launch counts of the package's CUDA kernels.

Each kernel wrapper adds one to its kernel's count where it launches the
kernel, and nowhere else, so a run can show which kernels a path went
through: set the counts to 0, drive the path, read them.
"""

from __future__ import annotations

import threading

# merge_small_k counts its launches alone (the k·P merge of the sharded
# paths); the merge stage inside scan_kernel, ivf_kernel and
# ivf_gather_kernel counts as theirs
LAUNCHES = {"scan_kernel": 0, "scan_kernel_bigk": 0, "ivf_kernel": 0,
            "merge_small_k": 0, "ivf_gather_kernel": 0}
_lock = threading.Lock()


def record(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
