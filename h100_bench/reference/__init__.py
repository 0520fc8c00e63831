"""The plain reference of the benchmark: a frozen copy of the plain
PyTorch paths of ``stereo_rcnn_tpu_torch`` (config, geometry, models,
NMS, the fused stereo RoIAlign's plain version with exact weights, 3D
solve, dense alignment and the synthetic renderer), importing nothing of
the program.  It runs in float32 with TF32 off (:mod:`.precision`); the
benchmark hands it the weights, images and calibration it hands the
program, and it works out everything else itself.  Later changes to the program do not move it.
"""
