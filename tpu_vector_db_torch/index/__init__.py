"""ANN indexes over the store's device matrix: IVF (k-means buckets) and
the beam graph (batched beam search over a flat navigable graph)."""

from tpu_vector_db_torch.index.beam_graph import BeamGraphIndex  # noqa: F401
from tpu_vector_db_torch.index.ivf import IVFIndex  # noqa: F401
