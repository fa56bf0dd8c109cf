"""Parallel forwards: the sequence-parallel (ring attention) encoder."""

from .sequence_parallel import make_sp_encoder, pad_to_multiple

__all__ = ["make_sp_encoder", "pad_to_multiple"]
