"""Benchmark of ``youtu_rag_tpu_torch``, the PyTorch and CUDA port."""
