"""Scale-out over several devices: meshes, sharded stores, the k·P merge.

Counterpart of ``tpu_vector_db/parallel``. A store's (N, d) rows split
row-wise over a mesh of torch devices driven from one process; each
device scans its rows to a local top-k, and the k·P candidates merge on
the lead device. Queries and results are whole on every device.
``bootstrap_distributed`` (multi-host serving) is not ported yet.
"""

from tpu_vector_db_torch.parallel.mesh import make_device_mesh  # noqa: F401
from tpu_vector_db_torch.parallel.sharded_scan import (  # noqa: F401
    make_sharded_query_fn)
from tpu_vector_db_torch.parallel.sharded_store import (  # noqa: F401
    ShardedVectorStore)
