"""Data parallelism across processes (port of multinerf_tpu/parallel)."""
