"""Synthetic KITTI-like stereo scenes with ground truth (numpy only).

Port of ``stereo_rcnn_tpu.data.synthetic``'s renderer and
``synthetic_batch``, so the port can render its inputs on a host without
JAX.  ``random_scene`` and ``render_pair`` are copies that consume the
identical rng stream: the same seed gives byte-identical images and
ground-truth arrays to ``stereo_rcnn_tpu.data.synthetic.synthetic_batch``
(pinned by ``tests/test_torch_bridges.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from stereo_rcnn_tpu_torch.config import Config
from stereo_rcnn_tpu_torch.data.kitti import (KittiObject, _all_corners_cam,
                                              _project_np,
                                              annotations_for_frame,
                                              pack_ground_truth)
from stereo_rcnn_tpu_torch.geometry.calib import (StereoCalib,
                                                  default_kitti_calib)
from stereo_rcnn_tpu_torch.train.targets import GroundTruth

#: Per-class geometry + appearance.  ``dims`` are (h, w, l) uniform ranges
#: roughly matching the KITTI class statistics (Car mean 1.53/1.63/3.88,
#: Van 2.21/1.90/5.08); ``tex_offset``/``tex_contrast`` reshape the object
#: texture distribution so classes are separable by APPEARANCE as well as
#: size (a classifier given only size would be scale/depth-confounded):
#: Car keeps the full-contrast noise texture, Van is washed out bright,
#: Truck is dark and low-contrast.  Face tints (orientation signal)
#: multiply on top identically for every class.
_CLASS_SPECS = {
    "Car": dict(h=(1.4, 1.8), w=(1.5, 1.8), l=(3.4, 4.5),
                tex_offset=0.0, tex_contrast=1.0),
    "Van": dict(h=(1.9, 2.4), w=(1.7, 2.0), l=(4.6, 5.5),
                tex_offset=70.0, tex_contrast=0.5),
    "Truck": dict(h=(2.8, 3.6), w=(2.3, 2.8), l=(7.0, 10.0),
                  tex_offset=-70.0, tex_contrast=0.5),
}


def random_scene(rng: np.random.RandomState, n_objects: int,
                 calib: StereoCalib, im_h: int, im_w: int,
                 class_names: Tuple[str, ...] = ("Car",)
                 ) -> List[KittiObject]:
    """Sample non-overlapping-ish object poses fully visible in both views.

    ``class_names`` selects which ``_CLASS_SPECS`` entries are drawn
    (uniformly per object).  The single-class default consumes the SAME
    rng stream as the historical Car-only renderer, so existing cached
    scene pools and seed-keyed tests stay byte-identical.
    """
    objs = []
    tries = 0
    while len(objs) < n_objects and tries < 200:
        tries += 1
        # Only draw the class sample when there is a choice — keeps the
        # rng stream identical to the historical Car-only renderer.
        name = (class_names[rng.randint(len(class_names))]
                if len(class_names) > 1 else class_names[0])
        spec = _CLASS_SPECS[name]
        z = rng.uniform(8.0, 40.0)
        x = rng.uniform(-0.35, 0.35) * z
        y = 1.65 + rng.uniform(-0.1, 0.1)
        dims = np.array([rng.uniform(*spec["h"]), rng.uniform(*spec["w"]),
                         rng.uniform(*spec["l"])], np.float32)
        ry = rng.uniform(-np.pi, np.pi)
        corners = _all_corners_cam(np.array([x, y, z]), dims, ry)
        uv_l = _project_np(corners, calib)
        uv_r = _project_np(corners, calib, right=True)
        box = np.array([uv_l[:, 0].min(), uv_l[:, 1].min(),
                        uv_l[:, 0].max(), uv_l[:, 1].max()], np.float32)
        if (box[0] < 2 or box[1] < 2 or box[2] > im_w - 2 or
                box[3] > im_h - 2 or uv_r[:, 0].min() < 2):
            continue
        if any(_iou(box, o.box) > 0.2 for o in objs):
            continue
        alpha = ry - np.arctan2(x, z)
        alpha = (alpha + np.pi) % (2 * np.pi) - np.pi
        objs.append(KittiObject(
            type=name, truncation=0.0, occlusion=0, alpha=float(alpha),
            box=box, dims=dims, location=np.array([x, y, z], np.float32),
            ry=float(ry)))
    # Sort far-to-near so nearer cars paint over farther ones.
    objs.sort(key=lambda o: -o.location[2])
    return objs


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[0] * wh[1]
    area = ((a[2] - a[0]) * (a[3] - a[1]) +
            (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return float(inter / max(area, 1e-9))


#: Deterministic per-face BGR tints (front +l, back -l, +w side, -w side).
#: Fixed across every scene so the face->appearance mapping is LEARNABLE:
#: with an untinted flat texture the viewpoint angle is visually
#: unobservable (a random-noise rectangle looks identical at every yaw,
#: modulo the stereo disparity profile which only fixes ry mod pi), and a
#: round-4 held-out error decomposition showed exactly that failure —
#: median yaw error ~1.4 rad and nearest-corner-type accuracy at chance
#: while depth/dims were within a few percent.  Real cars break the
#: symmetry with oriented appearance (lights, windshield, shading); these
#: tints plus the along-face gradient are the minimal synthetic analogue.
_FACE_TINTS = np.array([
    [0.55, 0.55, 1.35],   # front: red-ish
    [1.35, 0.55, 0.55],   # back: blue-ish
    [0.55, 1.35, 0.55],   # +w side: green-ish
    [1.10, 1.10, 0.45],   # -w side: cyan-ish
], np.float32)

#: Lambertian shading (appearance="shaded"): a fixed scene light in the
#: CAMERA frame.  Face brightness = ambient + diffuse * max(0, n . l)
#: where n is the outward normal of the visible vertical face — so
#: orientation is observable from ACHROMATIC, physically-motivated
#: shading (the way real cars reveal yaw) instead of the per-face color
#: code above.  The tints mode trivially leaks face identity through hue;
#: a model trained on "shaded" must invert the lighting model from the
#: two-face brightness profile and the brightness step at the projected
#: nearest corner, which is a strictly harder and more honest
#: orientation cue.  Light direction is horizontal (only vertical faces
#: are ray-cast), pointing from behind-right of the camera, unit norm.
_SHADE_LIGHT_XZ = np.array([0.45, -0.893], np.float64)
_SHADE_LIGHT_XZ /= np.linalg.norm(_SHADE_LIGHT_XZ)
_SHADE_AMBIENT = 0.45
_SHADE_DIFFUSE = 0.9

#: Renderer appearance modes (DataConfig.synthetic_appearance).
APPEARANCES = ("tints", "shaded", "plain")


def _surface_profile_np(us: np.ndarray, location: np.ndarray,
                        dims_hwl: np.ndarray, ry: float,
                        calib: StereoCalib):
    """Per-column (depth, face id, along-face coord, hit) of the visible
    box surface (numpy twin of ``solve.dense_align._visible_depth_profile``
    for the depth part): cast the left-camera ray of each column u against
    the object rectangle in bird's-eye view; misses fall back to the
    center depth."""
    x, z = float(location[0]), float(location[2])
    w_half, l_half = float(dims_hwl[1]) / 2, float(dims_hwl[2]) / 2
    s = (us - float(calib.cu)) / float(calib.f)
    c, si = np.cos(ry), np.sin(ry)
    o_x, o_z = -float(calib.tx2) - x, -z
    a1, b1 = c * s - si, c * o_x - si * o_z
    a2, b2 = si * s + c, si * o_x + c * o_z

    def slab(a, b, half):
        big = 1e9
        tiny = np.abs(a) < 1e-9
        safe = np.where(tiny, 1.0, a)
        t1, t2 = (-half - b) / safe, (half - b) / safe
        lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
        inside = abs(b) <= half
        lo = np.where(tiny, -big if inside else big, lo)
        hi = np.where(tiny, big if inside else -big, hi)
        return lo, hi

    lo1, hi1 = slab(a1, b1, l_half)
    lo2, hi2 = slab(a2, b2, w_half)
    t_enter = np.maximum(lo1, lo2)
    t_exit = np.minimum(hi1, hi2)
    hit = (t_enter <= t_exit) & (t_enter > 0.1)
    depth = np.where(hit, t_enter, z)
    # Entry point in the object frame: which face the ray entered through
    # (length-slab => front/back, width-slab => left/right side) and the
    # normalized [-1, 1] coordinate along that face.
    p_l = b1 + a1 * t_enter
    p_w = b2 + a2 * t_enter
    from_len = lo1 >= lo2
    face = np.where(from_len, np.where(p_l > 0, 0, 1),
                    np.where(p_w > 0, 2, 3)).astype(np.int32)
    along = np.where(from_len,
                     np.clip(p_w / max(w_half, 1e-6), -1.0, 1.0),
                     np.clip(p_l / max(l_half, 1e-6), -1.0, 1.0))
    return depth, face, along, hit


def render_pair(objs: List[KittiObject], calib: StereoCalib, im_h: int,
                im_w: int, rng: np.random.RandomState,
                appearance: str = "tints") -> Tuple[np.ndarray, np.ndarray]:
    """Paint each car with PHYSICALLY CORRECT per-pixel stereo
    correspondence; background is smooth noise.  Returns float32 BGR-ish
    images in [0, 255], shape [H, W, 3].

    The left view paints a texture over the object's 2D box; the right
    view splats each left texture column at ``u - f*b/z_surface(u)``,
    where z_surface is the ray-cast depth of the visible box surface for
    that column — the same geometry dense alignment models, so sub-pixel
    photometric refinement is well-posed on these scenes (a flat-sprite
    constant shift would bias it by the surface-vs-edge depth gap).

    ``appearance`` selects the orientation cue painted on object pixels:
    "tints" (per-face color code + along-face gradient), "shaded"
    (achromatic Lambertian face shading from a fixed scene light — see
    ``_SHADE_LIGHT_XZ``), or "plain" (no cue: orientation observable only
    from the stereo disparity profile).  All modes consume the identical
    rng stream, so the same seed yields the SAME scene geometry and
    textures across appearances/domains."""
    if appearance not in APPEARANCES:
        raise ValueError(f"unknown appearance {appearance!r}; "
                         f"known: {APPEARANCES}")
    def smooth_noise():
        small = rng.rand(im_h // 8 + 1, im_w // 8 + 1, 3) * 255
        img = np.kron(small, np.ones((8, 8, 1)))[:im_h, :im_w]
        return img.astype(np.float32)

    left = smooth_noise()
    right = left.copy()
    fb = float(calib.f) * float(calib.baseline)
    for o in objs:
        corners = _all_corners_cam(o.location, o.dims, o.ry)
        uv_l = _project_np(corners, calib)
        x1, y1 = uv_l[:, 0].min(), uv_l[:, 1].min()
        x2, y2 = uv_l[:, 0].max(), uv_l[:, 1].max()
        xi1, yi1 = max(int(x1), 0), max(int(y1), 0)
        xi2, yi2 = min(int(x2), im_w), min(int(y2), im_h)
        if xi2 <= xi1 or yi2 <= yi1:
            continue
        # Band-limited texture (random at 2 px, linearly upsampled): 1 px
        # white noise aliases under bilinear resampling and biases
        # photometric matching by ~0.1 px, which at 2 px disparities is a
        # 5% depth error; a band-limited signal interpolates faithfully.
        # Texture is drawn fresh per object from the scene rng — a
        # deterministic per-object texture would let a detector memorise
        # appearances instead of learning shape (observed: held-out
        # detection collapse when textures were keyed on object depth).
        tex_rng = rng
        th_, tw_ = yi2 - yi1, xi2 - xi1
        small = tex_rng.rand(th_ // 2 + 2, tw_ // 2 + 2, 3) * 255
        ry_ = (np.arange(th_) + 0.5) / 2.0
        rx_ = (np.arange(tw_) + 0.5) / 2.0
        y0_ = np.floor(ry_).astype(int); fy_ = (ry_ - y0_)[:, None, None]
        x0_ = np.floor(rx_).astype(int); fx_ = (rx_ - x0_)[None, :, None]
        tex = ((small[y0_][:, x0_] * (1 - fx_) +
                small[y0_][:, x0_ + 1] * fx_) * (1 - fy_) +
               (small[y0_ + 1][:, x0_] * (1 - fx_) +
                small[y0_ + 1][:, x0_ + 1] * fx_) * fy_)

        # Class-conditional texture distribution (see _CLASS_SPECS).  The
        # no-op Car case is skipped entirely so the historical Car-only
        # rendering stays byte-identical (cached pools, seed-keyed tests).
        spec = _CLASS_SPECS.get(o.type, _CLASS_SPECS["Car"])
        if spec["tex_contrast"] != 1.0 or spec["tex_offset"] != 0.0:
            tex = (128.0 + spec["tex_offset"]
                   + spec["tex_contrast"] * (tex - 128.0))

        # Orientation-observable appearance: tint each column by the BEV
        # face its camera ray hits (deterministic per-face colors) and an
        # along-face brightness gradient.  The tint discontinuity between
        # adjacent visible faces falls exactly at the projected nearest
        # corner — the perspective keypoint the keypoint branch regresses —
        # and carries into the right view with the correct disparity via
        # the same surface-depth splat below.
        us = np.arange(xi1, xi2, dtype=np.float64) + 0.5
        zs, face, along, hit = _surface_profile_np(
            us, o.location, o.dims, o.ry, calib)
        if appearance == "tints":
            gain = _FACE_TINTS[face] * (0.85 + 0.25 * along)[:, None]
            gain = np.where(hit[:, None], gain, 1.0)
            tex = np.clip(tex * gain[None, :, :], 0.0, 255.0)
        elif appearance == "shaded":
            # Outward normals of the 4 vertical faces in camera (x, z):
            # the object length axis in camera coords is (cos ry, -sin ry)
            # and the width axis (sin ry, cos ry) — the same frame
            # _surface_profile_np ray-casts in.
            c_, s_ = np.cos(o.ry), np.sin(o.ry)
            normals = np.array([[c_, -s_], [-c_, s_],
                                [s_, c_], [-s_, -c_]], np.float64)
            g4 = _SHADE_AMBIENT + _SHADE_DIFFUSE * np.clip(
                normals @ _SHADE_LIGHT_XZ, 0.0, None)
            gcol = np.where(hit, g4[face], 1.0)
            tex = np.clip(tex * gcol[None, :, None], 0.0, 255.0)
        left[yi1:yi2, xi1:xi2] = tex

        # Right view: bilinear-splat each left column at u - f*b/z(u).
        # The splat is a dense [tex_cols, span] weight-matrix product
        # (np.add.at is an order of magnitude slower on near, hundreds-of-
        # pixels-wide cars and was the training-loop bottleneck).
        targets = us - fb / zs - 0.5          # right-image column coords
        lo = np.floor(targets).astype(int)
        frac = targets - lo
        c0 = max(int(targets.min()), 0)
        c1 = min(int(targets.max()) + 2, im_w)
        if c1 <= c0:
            continue
        span = c1 - c0
        wmat = np.zeros((tw_, span))
        for off, wgt in ((0, 1.0 - frac), (1, frac)):
            cols = lo + off - c0
            ok = (cols >= 0) & (cols < span)
            wmat[np.nonzero(ok)[0], cols[ok]] += wgt[ok]
        acc = np.tensordot(tex, wmat, axes=([1], [0]))   # [th, 3, span]
        wacc = wmat.sum(0)
        painted = wacc > 0.3
        cols_abs = np.arange(c0, c1)[painted]
        right[yi1:yi2, cols_abs] = (acc[:, :, painted] /
                                    wacc[painted]).transpose(0, 2, 1)
    return left, right


def synthetic_batch(cfg: Config, batch: int, seed: int = 0,
                    n_objects: int = 4):
    """``(left, right, gt, calib)``: mean-subtracted BGR image pairs
    [B, H, W, 3] float32, the packed :class:`GroundTruth` with numpy leaves
    [B, G, ...], and the working-resolution calibration (the JAX package's
    ``synthetic_batch`` with ``domain="none"``)."""
    calib = default_kitti_calib()
    h, w = cfg.data.image_h, cfg.data.image_w
    # Scale nominal KITTI calib (1242x375) to the working resolution.
    calib_s = calib.scale(min(w / 1242.0, h / 375.0))
    rng = np.random.RandomState(seed)
    means = np.asarray(cfg.backbone.pixel_means_bgr, np.float32)
    class_names = tuple(cfg.data.classes[1:])
    unknown = [c for c in class_names if c not in _CLASS_SPECS]
    if unknown:
        raise ValueError(f"no synthetic renderer spec for classes "
                         f"{unknown}; known: {sorted(_CLASS_SPECS)}")
    imgs_l, imgs_r, gts = [], [], []
    for _ in range(batch):
        objs = random_scene(rng, n_objects, calib_s, h, w, class_names)
        il, ir = render_pair(objs, calib_s, h, w, rng,
                             appearance=cfg.data.synthetic_appearance)
        annos = annotations_for_frame(objs, calib_s, float(w), cfg.data)
        gts.append(pack_ground_truth(annos, cfg.train.max_gt_boxes))
        imgs_l.append(il - means)
        imgs_r.append(ir - means)
    gt = GroundTruth(*[np.stack(field) for field in zip(*gts)])
    return np.stack(imgs_l), np.stack(imgs_r), gt, calib_s


def synthetic_images(cfg: Config, batch: int, seed: int = 0,
                     n_objects: int = 4):
    """The image pairs and calibration of :func:`synthetic_batch`."""
    il, ir, _, calib = synthetic_batch(cfg, batch, seed, n_objects)
    return il, ir, calib
