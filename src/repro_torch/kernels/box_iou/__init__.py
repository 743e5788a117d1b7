from repro_torch.kernels.box_iou.ops import (
    box_iou,
    box_iou_plain,
    match_boxes,
    nms_mask,
)
