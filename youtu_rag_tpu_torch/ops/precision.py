"""Full-f32 matrix products that leave the caller's TF32 setting as it was.

The plain versions of the kernels, the reference re-scores and the plain
attention paths compute f32 products and hold them to f32 sums (the JAX
package's ``preferred_element_type=f32`` on exact inputs). A CUDA f32
matmul may run in TF32 when ``torch.backends.cuda.matmul.allow_tf32`` is
True, which keeps about three decimal digits. ``f32_matmul()`` turns it off
for the product it wraps and puts back whatever the caller had, also when
the body raises: the JAX package changes no process-wide setting, and a
trainer that chose TF32 keeps it across a search or a forward.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def f32_matmul():
    """Run the body with TF32 matmuls off; restore the caller's flag after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
