"""KITTI AP evaluation (numpy): a copy of ``stereo_rcnn_tpu.evalkit``."""

from stereo_rcnn_tpu_torch.evalkit.kitti_eval import (
    DIFFICULTIES, FrameObjects, evaluate, frame_objects_from_labels,
    frame_objects_from_outputs, read_result_file, write_result_file)
from stereo_rcnn_tpu_torch.evalkit.rotate_iou import (bev_corners, iou_3d,
                                                      rotated_iou_bev)
