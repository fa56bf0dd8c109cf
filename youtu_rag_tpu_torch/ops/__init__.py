from .topk import NEG_INF, topk_pruned, topk_pruned_reference

__all__ = ["NEG_INF", "topk_pruned", "topk_pruned_reference"]
