"""Scale-out over several devices: meshes, sharded stores, the k·P merge.

Counterpart of ``tpu_vector_db/parallel``. A store's (N, d) rows split
row-wise over a mesh of torch devices driven from one process; each
device scans its rows to a local top-k, and the k·P candidates merge on
the lead device. Queries and results are whole on every device.
Multi-host serving extends the same code over processes:
``bootstrap_distributed`` joins a gloo process group, and the mesh then
spans the processes (``mesh.py``).
"""

from tpu_vector_db_torch.parallel.mesh import (  # noqa: F401
    bootstrap_distributed, make_device_mesh)
from tpu_vector_db_torch.parallel.sharded_scan import (  # noqa: F401
    make_sharded_query_fn)
from tpu_vector_db_torch.parallel.sharded_store import (  # noqa: F401
    ShardedVectorStore)
