"""Procedural scene, ground-truth rendering and the per-frame video
substrate (numpy) — copies of the reference package's, drawing the same
random streams in the same order."""
from repro_torch.data.scene import CAR, PERSON, Scene, SceneConfig
from repro_torch.data.render import boxes_to_scene, gt_boxes, render_image
from repro_torch.data.dataset import (
    OBJ_IDS,
    Video,
    build_video,
    largest_object_table,
    motion_table,
)
