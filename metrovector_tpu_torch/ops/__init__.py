"""Device compute: the fused distance + top-k, ADC + top-k, gather +
rescore and sparse ELL scan + top-k kernels and their plain PyTorch
versions (counterpart of :mod:`metrovector_tpu.ops`), and the launch grid
the kernels' wrappers take (:class:`.grid.Grid`). Importing builds
nothing: the kernels are compiled at their first launch."""

from .adc_kernel import fused_adc_topk, fused_adc_topk_reference
from .distances import (
    distances_np,
    exact_topk,
    mask_scores,
    rescore_topk,
    scores_block,
    scores_to_distances,
    split_bf16x3,
)
from .grid import Grid
from .gather_kernel import (
    gather_rows,
    gather_rows_reference,
    rescore_candidates,
    rescore_candidates_reference,
)
from .sparse_kernel import ell_dots, ell_dots_reference, ell_topk, ell_topk_reference
from .topk_kernel import (
    fused_topk,
    fused_topk_presampled,
    fused_topk_presampled_reference,
    fused_topk_reference,
)

__all__ = [
    "Grid",
    "distances_np",
    "ell_dots",
    "ell_dots_reference",
    "ell_topk",
    "ell_topk_reference",
    "exact_topk",
    "fused_adc_topk",
    "fused_adc_topk_reference",
    "fused_topk",
    "fused_topk_presampled",
    "fused_topk_presampled_reference",
    "fused_topk_reference",
    "gather_rows",
    "gather_rows_reference",
    "mask_scores",
    "rescore_candidates",
    "rescore_candidates_reference",
    "rescore_topk",
    "scores_block",
    "scores_to_distances",
    "split_bf16x3",
]
