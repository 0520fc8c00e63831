from stereo_rcnn_tpu_torch.solve.box_estimator import (
    SolveResult, observations_from_detection, solve_batch, solve_pose)
from stereo_rcnn_tpu_torch.solve.dense_align import (AlignResult,
                                                     align_batch,
                                                     align_depth)
