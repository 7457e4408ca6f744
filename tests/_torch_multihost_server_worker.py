"""Server worker of tests/test_torch_multihost.py: the port's REST server
as one process of a two-process serving group.

    python _torch_multihost_server_worker.py COORDINATOR RANK HTTP_PORT

It sets the multi-host env, so the app's startup joins the gloo group
(``api/app.py`` ``_on_startup`` -> ``bootstrap_distributed``), and serves
``ShardedVectorStore``s over a mesh of one CPU shard a process
(``VECTOR_DB_SHARDED=1``, ``VDB_FORCE_CPU=1``). The parent drives both
servers in lockstep, as a fan-out tier does in production. The query
coalescer is off: each process's own batch window would form different
batches, and the processes' collectives would not match. At a clean exit
(SIGTERM) it prints that it never imported JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coordinator, process_id, http_port = sys.argv[1:4]
    os.environ["VECTOR_DB_COORDINATOR"] = coordinator
    os.environ["VECTOR_DB_NUM_PROCESSES"] = "2"
    os.environ["VECTOR_DB_PROCESS_ID"] = process_id
    os.environ["VECTOR_DB_SHARDED"] = "1"
    os.environ["VDB_FORCE_CPU"] = "1"
    os.environ["VDB_COALESCE_MS"] = "off"
    os.environ["HOST"] = "127.0.0.1"
    os.environ["PORT"] = http_port

    import torch
    torch.set_num_threads(1)
    from tpu_vector_db_torch.api.main import main as serve
    serve(["development"])
    assert "jax" not in sys.modules
    print(f"SERVER_EXIT_OK process={process_id} jax_loaded=False",
          flush=True)


if __name__ == "__main__":
    main()
