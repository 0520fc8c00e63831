"""stereo_rcnn_tpu_torch — the PyTorch + CUDA port of ``stereo_rcnn_tpu``.

The JAX package stays the reference; each module here keeps its JAX
counterpart's path and public names.  Every Pallas kernel of the JAX
package is a hand-written CUDA kernel here (``csrc/``): the fused stereo
RoIAlign in each sampling-weight mode (K1) and its backward (K2), the
windowed one-sided RoIAlign (K3) and the atlas variant (K4); each runs on
the card and as its plain PyTorch version on the CPU.  The Gauss-Newton 3D
solve, XLA-compiled ``jnp`` in the JAX package, is one kernel on the card
too (K5, ``solve.box_estimator``) and its plain loop on the CPU; so is the
epilogue of each folded backbone convolution, bias, residual and ReLU in
one pass, which XLA fuses into the convolution on the TPU (K6,
``ops.conv_epilogue``).  ``ops/cuda_build.py`` builds, launches and
dispatches all six.  The atlas gather RoIAlign (``ops.roi_align``) is
plain torch.  Nothing here imports JAX.
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
from stereo_rcnn_tpu_torch.ops.roi_align import (multilevel_roi_align,
                                                 roi_align)
from stereo_rcnn_tpu_torch.ops.roi_align_window import (
    multilevel_roi_align_window, multilevel_roi_align_window_ref,
    roi_align_window_kernel)
from stereo_rcnn_tpu_torch.ops.stereo_roi_align import (
    stereo_roi_align_atlas, stereo_roi_align_atlas_kernel,
    stereo_roi_align_atlas_ref, stereo_roi_align_kernel,
    stereo_roi_align_packed, stereo_roi_align_packed_ref)
