"""Device compute: the fused distance + top-k kernel and its plain
PyTorch version (counterpart of :mod:`metrovector_tpu.ops`)."""

from .distances import (
    distances_np,
    exact_topk,
    mask_scores,
    scores_block,
    scores_to_distances,
)
from .topk_kernel import fused_topk, fused_topk_reference

__all__ = [
    "distances_np",
    "exact_topk",
    "fused_topk",
    "fused_topk_reference",
    "mask_scores",
    "scores_block",
    "scores_to_distances",
]
