"""Typed configuration tree for the PyTorch port.

A field-for-field copy of ``stereo_rcnn_tpu.config``: the JAX package's
``__init__`` imports JAX, so the port cannot import its config on a host
without JAX.  ``tests/test_torch_bridges.py`` pins the two copies equal.
Every "top-N" is a padded static size, as in the JAX package, so the two
pipelines produce the same shapes.  PyYAML is imported only by
:func:`load_config`, when a YAML file is given; the port writes and reads
JSON (:func:`save_config`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """FPN anchor generation.

    Reference: ``lib/model/rpn/generate_anchors.py`` — ``generate_anchors``;
    cfg keys ``ANCHOR_SCALES``, ``ANCHOR_RATIOS``, ``FEAT_STRIDE``.
    One scale per pyramid level (P2..P6), three aspect ratios.
    """

    strides: Tuple[int, ...] = (4, 8, 16, 32, 64)        # FEAT_STRIDE per level
    # Base anchor side length (pixels) per level; area = scale^2.
    scales: Tuple[float, ...] = (32.0, 64.0, 128.0, 256.0, 512.0)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)           # ANCHOR_RATIOS

    @property
    def num_anchors_per_cell(self) -> int:
        return len(self.ratios)


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """Stereo RPN head + proposal selection.

    Reference: ``lib/model/rpn/stereo_rpn.py`` — ``_Stereo_RPN``;
    ``lib/model/rpn/proposal_layer.py`` — ``_ProposalLayer``.
    """

    conv_dim: int = 512                  # 3x3 conv channels on concat(P_L, P_R)
    # Proposal selection (all static shapes; cfg TRAIN/TEST.RPN_PRE_NMS_TOP_N
    # and RPN_POST_NMS_TOP_N in the reference).
    train_pre_nms_top_n: int = 2048
    train_post_nms_top_n: int = 512
    test_pre_nms_top_n: int = 1024
    test_post_nms_top_n: int = 300
    nms_thresh: float = 0.7              # cfg.TRAIN.RPN_NMS_THRESH
    min_size: float = 4.0                # cfg.TRAIN.RPN_MIN_SIZE (uncertain in ref)

    # Anchor target assignment (training).
    # Reference: lib/model/rpn/anchor_target_layer.py — _AnchorTargetLayer.
    batch_size: int = 256                # cfg.TRAIN.RPN_BATCHSIZE
    fg_fraction: float = 0.5             # cfg.TRAIN.RPN_FG_FRACTION
    positive_overlap: float = 0.7        # cfg.TRAIN.RPN_POSITIVE_OVERLAP
    negative_overlap: float = 0.3        # cfg.TRAIN.RPN_NEGATIVE_OVERLAP
    allowed_border: float = 0.0          # _AnchorTargetLayer._allowed_border
    # Background anchors with intersection/anchor-area above this vs an
    # ignore region (DontCare/Van) are excluded from negative sampling.
    ignore_overlap: float = 0.5


@dataclasses.dataclass(frozen=True)
class RCNNConfig:
    """Second-stage stereo head.

    Reference: ``lib/model/stereo_rcnn/stereo_rcnn.py`` — ``_StereoRCNN``;
    ``proposal_target_layer.py`` — ``_ProposalTargetLayer``.
    """

    pooling_size: int = 7                # cfg.POOLING_SIZE
    sampling_ratio: int = 2              # RoIAlign sampling_ratio
    # RoIAlign implementation: "xla" (the atlas gather, plain torch in
    # ``ops/roi_align.py``) or "pallas" (the fused stereo kernel, which
    # clamps sampling to a per-level window: the CUDA kernel in
    # ``ops/stereo_roi_align.py``).
    roi_align_impl: str = "xla"
    # Fused-kernel sampling-weight precision: "f32" (exact, default) or
    # "kron_bf16" / "kron_hilo" (one combined weight per window cell in
    # bf16, or bf16 hi + lo); the backward is the exact f32 one for all.
    roi_align_hat: str = "f32"
    fc_dim: int = 2048                   # FC trunk width after pooled concat
    num_classes: int = 2                 # ('__background__', 'Car')

    # Proposal target sampling (training).
    rois_per_image: int = 128            # cfg.TRAIN.BATCH_SIZE (RoIs)
    fg_fraction: float = 0.25            # cfg.TRAIN.FG_FRACTION
    fg_thresh: float = 0.5               # cfg.TRAIN.FG_THRESH
    bg_thresh_hi: float = 0.5            # cfg.TRAIN.BG_THRESH_HI
    bg_thresh_lo: float = 0.0            # cfg.TRAIN.BG_THRESH_LO
    # cfg.TRAIN.BBOX_NORMALIZE_STDS (0.1, 0.1, 0.2, 0.2), extended to the
    # stereo 6-tuple (right-u like u, right-w like w).  Targets are divided
    # by these at training time and predictions multiplied back at decode;
    # without it the ~0.1-magnitude deltas sit deep in smooth-L1's
    # quadratic zone and the box head under-trains by an order of
    # magnitude.  Means are zero as in the reference.
    bbox_target_stds: tuple = (0.1, 0.1, 0.2, 0.2, 0.1, 0.2)
    # RoIs mostly inside an ignore region are excluded from the bg pool.
    ignore_overlap: float = 0.5

    # Keypoint head: six 1-D distributions over `kpt_grid` horizontal bins
    # (4 perspective keypoint channels + 2 visible-boundary channels).
    kpt_grid: int = 28
    kpt_pool_size: int = 14              # RoIAlign size feeding keypoint branch
    # Softmax semantics of the 4 perspective-keypoint channels
    # (reference: stereo_rcnn.py keypoint branch — SURVEY.md §3.4 fact 5
    # is explicitly UNCERTAIN about this):
    #   "joint":       ONE softmax over the flattened (4 x kpt_grid) bins —
    #                  the corner type and the u-bin form a single
    #                  categorical (our default reconstruction).
    #   "per_channel": each corner-type channel is an independent
    #                  kpt_grid-bin softmax; training supervises only the
    #                  GT corner's channel, decode takes the highest
    #                  per-channel probability across all four.
    # Like `box_convention`, this is a parity switch: on first contact
    # with the real released `.pth`, tools/capture_golden.py reports which
    # semantics reproduces the reference kpts_prob, and flipping this flag
    # re-points BOTH the loss and the decode without retraining code.
    kpt_softmax: str = "joint"

    # Final detection post-processing (static shapes).
    score_thresh: float = 0.05
    final_nms_thresh: float = 0.3        # cfg.TEST.NMS
    max_detections: int = 32             # padded per-image detection count

    # Class-mean 3D dimensions (h, w, l) for Car on KITTI train; used as the
    # regression reference for the dim head (reference encodes dims relative
    # to the per-class mean size).
    mean_dims_hwl: Tuple[float, float, float] = (1.53, 1.63, 3.88)


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """ResNet-101 + FPN, caffe-style.

    Reference: ``lib/model/stereo_rcnn/resnet.py`` — ``resnet``, ``ResNet``,
    ``Bottleneck``; cfg.RESNET.FIXED_BLOCKS=1 (conv1+layer1 frozen),
    frozen BatchNorm throughout.
    """

    depth: int = 101                     # (3, 4, 23, 3) bottleneck blocks
    norm: str = "frozen"                 # "frozen" (pretrained BN constants,
                                         # the reference setup) | "affine"
                                         # (trainable scale/bias, zero-gamma
                                         # init; tree-identical to frozen so
                                         # its checkpoints serve in the
                                         # frozen inference program) |
                                         # "group" (GroupNorm)
    # FPN top-down upsample: "bilinear" is reference-exact
    # (resnet.py _upsample_add, F.upsample mode='bilinear'); "nearest" is a
    # cheaper measured deviation.
    fpn_upsample: str = "bilinear"
    fpn_dim: int = 256                   # FPN output channels P2..P6
    frozen_stages: int = 1               # cfg.RESNET.FIXED_BLOCKS
    # Rematerialise bottlenecks on backward (jax.checkpoint): ~3x less
    # backbone activation HBM for ~+1/3 backbone FLOPs in the bwd pass.
    # Enables large-batch / full-res training alongside a staged data pool.
    remat: bool = False
    # Caffe BGR channel means (cfg.PIXEL_MEANS).
    pixel_means_bgr: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """3D box estimation + dense photometric alignment.

    Reference: ``lib/model/utils/box_estimator.py`` —
    ``solve_x_y_z_theta_from_kpt`` / ``solve_x_y_theta_from_kpt``;
    ``lib/model/dense_align/dense_align.py`` — ``align_parallel``.
    """

    gn_iters: int = 30                   # Gauss-Newton iterations (fixed count)
    gn_damping: float = 1e-3             # Levenberg damping for the 4x4 solve
    # Dense alignment depth sweep: coarse then fine, both fixed-size.
    align_coarse_range: float = 2.0      # metres around initial z
    align_coarse_candidates: int = 41    # => 0.1 m steps over +-2 m
    align_fine_range: float = 0.25
    align_fine_candidates: int = 21      # => 0.025 m steps
    align_grid_h: int = 24               # photometric sample grid (rows)
    align_grid_w: int = 48               # photometric sample grid (cols)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization loop.

    Reference: ``trainval_net.py`` — SGD(momentum=0.9), lr 1e-3 decayed 10x,
    gradient clipping, learned 6-way uncertainty loss weighting
    (``uncert`` tensor), checkpoint each epoch.
    """

    learning_rate: float = 1e-3          # args.lr
    momentum: float = 0.9                # cfg.TRAIN.MOMENTUM
    weight_decay: float = 5e-4           # cfg.TRAIN.WEIGHT_DECAY (uncertain)
    lr_decay_step: int = 10              # args.lr_decay_step (epochs)
    lr_decay_gamma: float = 0.1          # cfg.TRAIN.GAMMA
    grad_clip: float = 10.0              # net_utils.clip_gradient
    epochs: int = 12
    batch_per_device: int = 1            # stereo pairs per chip per step
    max_gt_boxes: int = 24               # padded GT count per image
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """KITTI input pipeline.

    Reference: ``lib/datasets/kitti.py``, ``lib/roi_data_layer/*``.
    Working resolution per BASELINE.md: 1280x384.
    """

    image_h: int = 384                   # padded training height
    image_w: int = 1280                  # padded training width
    kitti_root: str = "data/kitti/object"
    classes: Tuple[str, ...] = ("__background__", "Car")
    # Treat these KITTI types as ignore regions (no loss): reference treats
    # Van/DontCare specially (uncertain exact semantics — SURVEY.md §2.2).
    ignore_types: Tuple[str, ...] = ("Van", "Truck", "DontCare")
    # Orientation cue the synthetic renderer paints on objects (KITTI data
    # ignores this): "tints" (per-face color code), "shaded" (achromatic
    # Lambertian face shading from a fixed light — the physically-honest
    # cue), "plain" (none).  See data/synthetic.py::APPEARANCES.
    synthetic_appearance: str = "tints"


@dataclasses.dataclass(frozen=True)
class Config:
    anchors: AnchorConfig = dataclasses.field(default_factory=AnchorConfig)
    rpn: RPNConfig = dataclasses.field(default_factory=RPNConfig)
    rcnn: RCNNConfig = dataclasses.field(default_factory=RCNNConfig)
    backbone: BackboneConfig = dataclasses.field(default_factory=BackboneConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    # Compute dtype for conv/matmul heavy paths (params stay f32).
    compute_dtype: str = "bfloat16"
    # 2D box-width convention: "legacy" = reference-exact "+1" widths
    # (``bbox_transform.py``: w = x2 - x1 + 1 in encode/decode/IoU, clip to
    # size-1) — required for released-checkpoint parity; "continuous" =
    # modern w = x2 - x1.  Sub-pixel shifts move IoU thresholds enough to
    # change AP tenths (SURVEY §7), hence config-level, default reference-
    # exact.  See geometry/boxes.py for the exact quirk set.
    box_convention: str = "legacy"

    @property
    def box_off(self) -> float:
        """Width offset threaded into geometry/boxes functions."""
        return 1.0 if self.box_convention == "legacy" else 0.0

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)


def _deep_tuple(value: Any) -> Any:
    """A list, and the lists inside it (per-class ``mean_dims_hwl`` rows),
    as tuples."""
    if isinstance(value, list):
        return tuple(_deep_tuple(v) for v in value)
    return value


def _update_dataclass(obj: Any, overrides: Mapping[str, Any]) -> Any:
    """Recursively apply a nested mapping of overrides to a dataclass tree."""
    changes = {}
    for key, value in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"Unknown config key: {key!r} on {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            changes[key] = _update_dataclass(current, value)
        else:
            if isinstance(current, tuple) and isinstance(value, Sequence):
                value = tuple(_deep_tuple(v) for v in value)
            changes[key] = value
    return dataclasses.replace(obj, **changes)


def parse_set_overrides(pairs: Sequence[str]) -> dict:
    """Parse CLI ``--set a.b.c=value`` pairs into the nested override
    mapping :func:`load_config` accepts.  Mirrors the reference's
    ``cfg_from_list`` (``--set_cfgs``).  Values stay strings — intended
    for string-typed knobs (e.g. ``rcnn.roi_align_hat=kron_bf16``);
    numeric keys should use a YAML overlay instead."""
    overrides: dict = {}
    for kv in pairs:
        key, sep, val = kv.partition("=")
        if not sep or not key:
            raise ValueError(f"--set expects KEY=VALUE, got {kv!r}")
        node = overrides
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return overrides


def load_config(yaml_path: str | None = None,
                overrides: Mapping[str, Any] | None = None,
                base: Config | None = None) -> Config:
    """Build a Config, optionally overlaying a file then a dict.

    Mirrors the reference's ``cfg_from_file`` + ``cfg_from_list`` layering.
    ``base`` starts the overlay from an existing config instead of the
    defaults (e.g. ``tiny_test_config()`` + a small delta in tests).  A
    ``.json`` file is read with the standard library (the port's own
    format: :func:`save_config` writes it, and a host without PyYAML
    reads it); any other file is YAML.  List values of tuple fields come
    back as tuples, nested lists as nested tuples, so a saved config
    loads equal to the original.
    """
    cfg = Config() if base is None else base
    if yaml_path is not None:
        with open(yaml_path) as f:
            if yaml_path.endswith(".json"):
                tree = json.load(f)
            else:
                import yaml
                tree = yaml.safe_load(f)
        cfg = _update_dataclass(cfg, tree or {})
    if overrides:
        cfg = _update_dataclass(cfg, overrides)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as JSON (``dataclasses.asdict``), which
    :func:`load_config` reads back equal."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)
        f.write("\n")


def synthetic_fullres_config() -> Config:
    """``configs/synthetic_fullres.yml`` over ``Config()``, built without
    PyYAML: ResNet-101 with GroupNorm-32 and rematerialised bottlenecks, the
    fused stereo RoIAlign, 1280x384, batch 8 (pinned equal to the YAML by
    ``tests/test_torch_bridges.py``)."""
    base = Config()
    return dataclasses.replace(
        base,
        backbone=dataclasses.replace(base.backbone, norm="group", remat=True),
        rcnn=dataclasses.replace(base.rcnn, roi_align_impl="pallas"),
        train=dataclasses.replace(base.train, learning_rate=0.002,
                                  lr_decay_step=48, epochs=64,
                                  batch_per_device=8))


def synthetic_multiclass_config() -> Config:
    """``configs/synthetic_multiclass.yml`` over ``Config()``, built without
    PyYAML: :func:`synthetic_fullres_config` with three classes
    (background / Car / Van), Truck and DontCare ignored, and per-class
    mean (h, w, l): Car's KITTI train means, Van's the middle of the
    renderer's Van sizes (pinned equal to the YAML by
    ``tests/test_torch_multiclass.py``)."""
    base = synthetic_fullres_config()
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, classes=("__background__", "Car", "Van"),
            ignore_types=("Truck", "DontCare")),
        rcnn=dataclasses.replace(
            base.rcnn, num_classes=3,
            mean_dims_hwl=((1.53, 1.63, 3.88), (2.15, 1.85, 5.05))))


def tiny_test_config() -> Config:
    """A miniature config for fast CPU tests: small images, small backbone
    budgets, tiny static top-Ns.  Keeps every code path identical."""
    cfg = Config()
    cfg = _update_dataclass(cfg, {
        "backbone": {"depth": 26, "norm": "group"},
        "data": {"image_h": 128, "image_w": 256},
        "rpn": {
            "train_pre_nms_top_n": 128, "train_post_nms_top_n": 64,
            "test_pre_nms_top_n": 128, "test_post_nms_top_n": 32,
            "batch_size": 64,
        },
        "rcnn": {"rois_per_image": 16, "max_detections": 8},
        "train": {"max_gt_boxes": 8},
        "solver": {
            "gn_iters": 20,
            "align_coarse_candidates": 11, "align_fine_candidates": 7,
            "align_grid_h": 8, "align_grid_w": 16,
        },
    })
    return cfg
