"""ANN indexes over the store's device matrix: IVF (k-means buckets)."""

from tpu_vector_db_torch.index.ivf import IVFIndex  # noqa: F401
