from .kmeans import kmeans_assign, kmeans_fit
from .topk import NEG_INF, fused_topk, topk, topk_pruned, topk_pruned_reference, xla_topk

# the JAX package's ops surface (its ``pallas_topk`` and ``pallas_topk_pruned``
# are ``topk`` and ``topk_pruned`` here), and the plain bf16 version
__all__ = ["fused_topk", "xla_topk", "topk", "topk_pruned", "kmeans_fit", "kmeans_assign",
           "NEG_INF", "topk_pruned_reference"]
