"""The benchmark's harness: set-up from the seed, traffic, tracing, the
metrics and the check. Imports the port (``youtu_rag_tpu_torch``) and
never the JAX package."""
