from stereo_rcnn_tpu_torch.geometry.calib import (StereoCalib,
                                                  calib_from_p2_p3,
                                                  default_kitti_calib,
                                                  read_kitti_calib)
from stereo_rcnn_tpu_torch.geometry.boxes import (box_area, clip_boxes,
                                                  cxcywh_to_xyxy,
                                                  decode_boxes,
                                                  decode_stereo_boxes,
                                                  encode_boxes,
                                                  encode_stereo_boxes,
                                                  pairwise_iou, union_box,
                                                  xyxy_to_cxcywh)
from stereo_rcnn_tpu_torch.geometry.anchors import (anchors_per_level,
                                                    base_anchors,
                                                    generate_anchors,
                                                    level_shapes)
from stereo_rcnn_tpu_torch.geometry.projection import (box2d_from_3d,
                                                       box3d_corners,
                                                       perspective_keypoints,
                                                       project,
                                                       project_box3d,
                                                       ry_from_alpha,
                                                       viewpoint_alpha,
                                                       visible_keypoint_index)
