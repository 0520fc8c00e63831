"""Rotated-rectangle IoU in bird's-eye view + 3D IoU.

The reference repo vendors NO evaluator (SURVEY.md §3.3: AP is computed by
the external KITTI C++ devkit).  This module implements the geometric core
needed for AP_bev / AP_3d: exact convex-polygon intersection of yawed BEV
rectangles via Sutherland–Hodgman clipping, fully vectorised numpy over
[N, M] pairs, on the host.

A copy of ``stereo_rcnn_tpu.evalkit.rotate_iou`` (pinned equal by
``tests/test_torch_evalkit.py``).
"""

from __future__ import annotations

import numpy as np


def bev_corners(x: np.ndarray, z: np.ndarray, w: np.ndarray, l: np.ndarray,
                ry: np.ndarray) -> np.ndarray:
    """[..., 4, 2] BEV rectangle corners (x, z), KITTI yaw convention
    (matches geometry.projection: X = x + c*xo + s*zo, Z = z - s*xo + c*zo,
    xo = ±l/2, zo = ±w/2)."""
    c, s = np.cos(ry), np.sin(ry)
    xo = np.stack([l / 2, l / 2, -l / 2, -l / 2], -1)
    zo = np.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    cx = x[..., None] + c[..., None] * xo + s[..., None] * zo
    cz = z[..., None] - s[..., None] * xo + c[..., None] * zo
    return np.stack([cx, cz], axis=-1)


def _polygon_area(poly: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Shoelace area of padded polygons [..., K, 2] with n_valid vertices."""
    k = poly.shape[-2]
    idx = np.arange(k)
    nxt = (idx + 1) % k
    # Treat invalid vertices by wrapping: replace vertex i >= n with vertex 0
    # — we instead compute area with explicit masking below.
    x, y = poly[..., 0], poly[..., 1]
    area = np.zeros(poly.shape[:-2])
    for i in range(k):
        j_arr = np.where(i + 1 < n_valid, i + 1, 0)
        xj = np.take_along_axis(x, j_arr[..., None], -1)[..., 0]
        yj = np.take_along_axis(y, j_arr[..., None], -1)[..., 0]
        valid = i < n_valid
        area = area + np.where(valid, x[..., i] * yj - xj * y[..., i], 0.0)
    return 0.5 * np.abs(area)


def _clip_polygon(poly: np.ndarray, n_valid: np.ndarray, a: np.ndarray,
                  b: np.ndarray, cap: int = 12):
    """Clip padded polygons by the half-plane left of directed edge a->b.

    poly: [..., cap, 2]; a, b: [..., 2].  Fixed capacity `cap` (a convex
    quad clipped by 4 half-planes needs at most 8 vertices; degenerate
    edge-on-edge cases may emit a few more, which are clamped — the dropped
    slivers have zero area).
    """
    k = poly.shape[-2]
    edge = b - a                                        # [..., 2]
    rel = poly - a[..., None, :]
    # signed cross product: >= 0 means inside (left of edge) for CCW polys.
    side = (edge[..., None, 0] * rel[..., 1] -
            edge[..., None, 1] * rel[..., 0])           # [..., k]

    out = np.zeros(poly.shape[:-2] + (cap, 2))
    out_n = np.zeros(poly.shape[:-2], dtype=np.int64)

    def emit(point, do_emit):
        nonlocal out, out_n
        idx = np.minimum(out_n, cap - 1)
        cur = np.take_along_axis(out, idx[..., None, None].repeat(2, -1), -2)
        np.put_along_axis(
            out, idx[..., None, None].repeat(2, -1),
            np.where(do_emit[..., None, None], point[..., None, :], cur), -2)
        out_n = np.minimum(out_n + do_emit.astype(np.int64), cap)

    # K <= cap is small, so the python loop is cheap; everything inside is
    # vectorised over the pair axes.
    for i in range(k):
        valid_i = i < n_valid
        j_arr = np.where(i + 1 < n_valid, i + 1, 0)
        pj = np.take_along_axis(poly, j_arr[..., None, None]
                                .repeat(2, -1), -2)[..., 0, :]
        pi = poly[..., i, :]
        si = side[..., i]
        sj = np.take_along_axis(side, j_arr[..., None], -1)[..., 0]

        in_i = si >= 0
        in_j = sj >= 0
        denom = si - sj
        safe = np.abs(denom) > 1e-12
        t = np.where(safe, si / np.where(safe, denom, 1.0), 0.0)
        inter = pi + (pj - pi) * t[..., None]

        emit(pi, valid_i & in_i)
        emit(inter, valid_i & (in_i != in_j) & safe)
    return out, out_n


def rotated_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """IoU matrix [N, M] of BEV boxes given as [x, z, w, l, ry]."""
    n, m = len(boxes_a), len(boxes_b)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    ca = bev_corners(*[boxes_a[:, i] for i in range(5)])    # [N, 4, 2]
    cb = bev_corners(*[boxes_b[:, i] for i in range(5)])    # [M, 4, 2]

    # Ensure CCW orientation (shoelace sign).
    def ccw(c):
        x, y = c[..., 0], c[..., 1]
        s = np.sum(x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y, -1)
        return np.where(s[..., None, None] < 0, c[..., ::-1, :], c)

    ca, cb = ccw(ca), ccw(cb)

    # Broadcast to [N, M, ...]: clip A by each edge of B.
    poly = np.zeros((n, m, 12, 2))
    poly[:, :, :4] = np.broadcast_to(ca[:, None], (n, m, 4, 2))
    n_valid = np.full((n, m), 4, dtype=np.int64)
    for e in range(4):
        a = np.broadcast_to(cb[None, :, e], (n, m, 2))
        b = np.broadcast_to(cb[None, :, (e + 1) % 4], (n, m, 2))
        poly, n_valid = _clip_polygon(poly, n_valid, a, b)

    inter = _polygon_area(poly, n_valid)
    area_a = _polygon_area(ca, np.full((n,), 4))[:, None]
    area_b = _polygon_area(cb, np.full((m,), 4))[None, :]
    union = area_a + area_b - inter
    return np.where(union > 1e-9, inter / np.maximum(union, 1e-9), 0.0)


def iou_3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """3D IoU matrix for boxes [x, y, z, h, w, l, ry] (y = bottom, KITTI).

    3D intersection = BEV polygon intersection x vertical overlap.
    """
    n, m = len(boxes_a), len(boxes_b)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    bev_a = boxes_a[:, [0, 2, 4, 5, 6]]
    bev_b = boxes_b[:, [0, 2, 4, 5, 6]]
    ca = bev_corners(*[bev_a[:, i] for i in range(5)])
    cb = bev_corners(*[bev_b[:, i] for i in range(5)])

    def ccw(c):
        x, y = c[..., 0], c[..., 1]
        s = np.sum(x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y, -1)
        return np.where(s[..., None, None] < 0, c[..., ::-1, :], c)

    ca, cb = ccw(ca), ccw(cb)
    poly = np.zeros((n, m, 12, 2))
    poly[:, :, :4] = np.broadcast_to(ca[:, None], (n, m, 4, 2))
    n_valid = np.full((n, m), 4, dtype=np.int64)
    for e in range(4):
        a = np.broadcast_to(cb[None, :, e], (n, m, 2))
        b = np.broadcast_to(cb[None, :, (e + 1) % 4], (n, m, 2))
        poly, n_valid = _clip_polygon(poly, n_valid, a, b)
    inter_bev = _polygon_area(poly, n_valid)

    # Vertical overlap: boxes span [y - h, y] (y is DOWN in camera frame).
    top_a, bot_a = boxes_a[:, 1] - boxes_a[:, 3], boxes_a[:, 1]
    top_b, bot_b = boxes_b[:, 1] - boxes_b[:, 3], boxes_b[:, 1]
    overlap_y = np.maximum(
        0.0, np.minimum(bot_a[:, None], bot_b[None, :]) -
        np.maximum(top_a[:, None], top_b[None, :]))
    inter = inter_bev * overlap_y
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    union = vol_a + vol_b - inter
    return np.where(union > 1e-9, inter / np.maximum(union, 1e-9), 0.0)
