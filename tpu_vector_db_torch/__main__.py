"""``python -m tpu_vector_db_torch [development|production]`` — serve the REST
API on the CUDA card (``VDB_FORCE_CPU=1``: on the CPU)."""

from tpu_vector_db_torch.api.main import main

if __name__ == "__main__":
    main()
