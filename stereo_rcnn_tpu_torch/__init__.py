"""stereo_rcnn_tpu_torch — the PyTorch + CUDA port of ``stereo_rcnn_tpu``.

The JAX package stays the reference; each module here keeps its JAX
counterpart's path and public names.  The fused stereo RoIAlign runs as a
hand-written CUDA kernel (``csrc/stereo_roi_align.cu``) on the card and as
its plain PyTorch version on the CPU.  Nothing here imports JAX.
"""

__version__ = "0.1.0"

from stereo_rcnn_tpu_torch.config import Config, load_config, tiny_test_config
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
from stereo_rcnn_tpu_torch.geometry.calib import (StereoCalib,
                                                  default_kitti_calib)
from stereo_rcnn_tpu_torch.inference import (Detections3D, broadcast_calib,
                                             make_full_pipeline,
                                             solve_and_align)
from stereo_rcnn_tpu_torch.models.detector import (Detections, StereoRCNN,
                                                   init_params,
                                                   make_inference_fn)
from stereo_rcnn_tpu_torch.ops.stereo_roi_align import (
    stereo_roi_align_kernel, stereo_roi_align_packed,
    stereo_roi_align_packed_ref)
