"""Parallel forwards: the sequence-parallel (ring attention) encoder; the
MoE encoder of ``expert_parallel`` (its single-device half) is imported by
its path, as it pulls in the model stack."""

from .sequence_parallel import make_sp_encoder, pad_to_multiple

__all__ = ["make_sp_encoder", "pad_to_multiple"]
