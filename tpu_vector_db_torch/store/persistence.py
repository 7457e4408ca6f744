"""Store persistence: vectors.npz + metadata.jsonl + manifest.json.

Same on-disk contract as the reference (``_save_store``/``_load_store``,
service/optimized_vector_store.py:218-239: mx.savez vectors + one-JSON-per-line
metadata; corrupt files fall back to an empty store) with two fixes the survey
called out: every file is written atomically (tmp + os.replace) and a manifest
records config + count + format version so loads can detect mismatches instead
of silently mis-shaping.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np

from tpu_vector_db_torch.store.config import VectorStoreConfig
from tpu_vector_db_torch.utils.fs import atomic_save_npz, atomic_write_bytes, ensure_directory

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1
VECTORS_FILE = "vectors.npz"
METADATA_FILE = "metadata.jsonl"
MANIFEST_FILE = "manifest.json"


class StoreDimensionMismatch(ValueError):
    """Persisted vectors disagree with the requested config dimension.

    Raised (never swallowed) so an operator mistake can't silently open an
    empty store over real data and overwrite it on the next add — the
    data-loss path the reference's tolerant loader allowed
    (optimized_vector_store.py:237-239)."""


def load_manifest_config(path: str | Path) -> VectorStoreConfig | None:
    """Read the persisted config back from manifest.json, or None.

    The manifest is the source of truth for a reopened store: a restart
    must come back with the same dimension/metric/dtype/ANN settings it was
    created with, not process defaults."""
    mf = Path(path) / MANIFEST_FILE
    if not mf.exists():
        return None
    try:
        manifest = json.loads(mf.read_text())
        cfg = manifest.get("config")
        return VectorStoreConfig.from_dict(cfg) if cfg else None
    except Exception:  # noqa: BLE001 — corrupt manifest: caller decides
        logger.exception("unreadable manifest at %s", mf)
        return None


def save_store(path: str | Path, vectors: np.ndarray, metadata: list[dict],
               config: VectorStoreConfig) -> None:
    """Atomically persist the full store state. ``vectors`` is (count, d) f32."""
    p = ensure_directory(path)
    atomic_save_npz(p / VECTORS_FILE, vectors=vectors.astype(np.float32))
    lines = "\n".join(json.dumps(m, ensure_ascii=False) for m in metadata)
    atomic_write_bytes(p / METADATA_FILE, (lines + "\n" if lines else "").encode())
    manifest = {
        "format_version": FORMAT_VERSION,
        "count": int(vectors.shape[0]),
        "dimension": int(config.dimension),
        "config": config.to_dict(),
    }
    atomic_write_bytes(p / MANIFEST_FILE, json.dumps(manifest, indent=2).encode())


def _manifest_count(p: Path) -> int | None:
    try:
        manifest = json.loads((p / MANIFEST_FILE).read_text())
        return int(manifest["count"])
    except Exception:  # noqa: BLE001 — absent/corrupt manifest: no trim
        return None


def load_store(path: str | Path, config: VectorStoreConfig):
    """Load (vectors, metadata) or (None, None) if absent/corrupt.

    Corruption tolerance matches the reference (fall back to empty,
    optimized_vector_store.py:237-239) but logs loudly instead of passing.
    """
    p = Path(path)
    vf, mf = p / VECTORS_FILE, p / METADATA_FILE
    if not vf.exists():
        return None, None
    try:
        with np.load(vf) as z:
            vectors = np.asarray(z["vectors"], dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != config.dimension:
            # NOT corruption: the data is fine, the caller's config is wrong.
            # Refuse to open instead of falling through to an empty store
            # that the next sync add would persist over the real data.
            raise StoreDimensionMismatch(
                f"store at {p} holds {vectors.shape[1] if vectors.ndim == 2 else '?'}-D "
                f"vectors but config requests {config.dimension}-D; refusing "
                "to open (pass the matching config or omit it to load from "
                "the manifest)")
        # Torn-write recovery: save_store writes vectors -> metadata ->
        # manifest, each atomically, so the manifest's count is the commit
        # point. A crash between files can leave vectors.npz AHEAD of the
        # manifest; trim back to the last committed prefix instead of
        # serving rows whose metadata/manifest never landed. (Appends are
        # strictly ordered, so the prefix is exactly the pre-crash state.)
        committed = _manifest_count(p)
        if committed is not None and committed < vectors.shape[0]:
            logger.warning(
                "store at %s: vectors.npz has %d rows but manifest "
                "committed %d (torn write); serving the committed prefix",
                p, vectors.shape[0], committed)
            vectors = vectors[:committed]
        metadata: list[dict] = []
        if mf.exists():
            with open(mf, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if line:
                        metadata.append(json.loads(line))
        if len(metadata) < vectors.shape[0]:
            metadata.extend({} for _ in range(vectors.shape[0] - len(metadata)))
        elif len(metadata) > vectors.shape[0]:
            metadata = metadata[: vectors.shape[0]]
        return vectors, metadata
    except StoreDimensionMismatch:
        raise
    except Exception:  # noqa: BLE001 — any corruption -> empty store
        logger.exception("corrupt store at %s; starting empty", p)
        return None, None
