from ubdvss_tpu_torch.ops.ccl import connected_components, label_propagation
from ubdvss_tpu_torch.ops.postproc import (
    postprocess,
    postprocess_batch,
    postprocess_batch_fused,
)
from ubdvss_tpu_torch.ops.rect import (
    min_area_rect,
    min_area_rect_from_extremes,
    min_area_rect_from_mask_stack,
    monotone_chain_hull,
)

__all__ = [
    "connected_components",
    "label_propagation",
    "monotone_chain_hull",
    "min_area_rect",
    "min_area_rect_from_extremes",
    "min_area_rect_from_mask_stack",
    "postprocess",
    "postprocess_batch",
    "postprocess_batch_fused",
]
