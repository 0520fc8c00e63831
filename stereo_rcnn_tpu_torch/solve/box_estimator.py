"""Batched 3D box estimation by damped Gauss-Newton (torch).

Port of ``stereo_rcnn_tpu.solve.box_estimator``.  The state (x, y, z,
theta) of every detection is fitted to the 7 observations
``[ul, vt, ur, vb, ul', ur', up]`` (left box edges, right box horizontal
edges, perspective-keypoint u), predicted by projecting the 3D box and
taking extremes over its 8 corners.  The JAX package takes the Jacobian
from 4 JVPs, one per state dimension; here :func:`_observe_jac` writes
those JVPs out and computes them with the observations in one pass (the
min/max derivative is shared among tied corners, as both frameworks'
JVPs share it).  The 4x4 normal equations are solved by an unrolled
Cholesky, each step is clipped to ``max_step`` and z is floored at 0.5.

:func:`solve_batch` calls the registered op ``stereo_rcnn_tpu_torch::
gauss_newton_solve`` (one graph node under ``torch.export``; made by
``ops/cuda_build.kernel_op``, whose function calls the op only when
traced): a CUDA tensor launches K5 (``csrc/box_solve.cu``,
:data:`gauss_newton_solve_kernel`), the whole solve in one launch, or
raises; a CPU tensor runs :func:`solve_batch_ref`, the plain loop, which
the kernel is held to.

``calib`` fields are per-detection ``[N]`` tensors (or numbers).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
from stereo_rcnn_tpu_torch.geometry.projection import (_CORNERS_X,
                                                       _CORNERS_Z,
                                                       box3d_corners, project)
from stereo_rcnn_tpu_torch.ops.cuda_build import CudaKernel, kernel_op


class SolveResult(NamedTuple):
    position: torch.Tensor   # [N, 3] (x, y, z) bottom-center
    theta: torch.Tensor      # [N] yaw ry
    residual: torch.Tensor   # [N] final RMS residual (pixels)


def _per_corner(calib: StereoCalib) -> StereoCalib:
    """[N] calib fields -> [N, 1], to broadcast over the 8 corners."""
    return StereoCalib(*[v[..., None] if torch.is_tensor(v) else v
                         for v in calib])


def _project_jac(pts, d_pts, calib8: StereoCalib, right: bool):
    """Pixel (u, v) [N, 8] of corners and their derivatives [N, 8, 4].

    pts: (x, y, z) [N, 8] each; d_pts: their derivatives [N, 8, 4].  The
    values use :func:`project`'s formula; the derivatives are its JVP,
    with the z floor's derivative split evenly at a tie as JAX's is."""
    x, y, z = pts
    dx, dy, dz = d_pts
    offset = calib8.tx2 - (calib8.baseline if right else 0.0)
    uv = project(torch.stack(pts, dim=-1), calib8, right=right)
    zc = torch.clamp(z, min=1e-3)
    gate = (z > 1e-3).float() + 0.5 * (z == 1e-3).float()
    dzc = dz * gate[..., None]
    g = (calib8.f / zc)[..., None]
    du = g * (dx - ((x + offset) / zc)[..., None] * dzc)
    dv = g * (dy - (y / zc)[..., None] * dzc)
    return uv[..., 0], uv[..., 1], du, dv


def _extreme(vals, d_vals, largest: bool):
    """amax/amin over the corners [N, 8] and its derivative [N, 4], shared
    evenly among tied corners (the max/min JVP of both frameworks)."""
    ans = vals.amax(1) if largest else vals.amin(1)
    tie = (vals == ans[:, None]).float()
    d = (d_vals * tie[..., None]).sum(1) / tie.sum(1)[:, None]
    return ans, d


def _observe_jac(state: torch.Tensor, dims_hwl: torch.Tensor,
                 kpt_idx: torch.Tensor, calib: StereoCalib):
    """Predicted observations [N, 7] from state [N, 4], and their Jacobian
    [N, 7, 4] in the same pass: the four JVPs of the JAX package, written
    out, so one Gauss-Newton step launches one set of kernels rather than
    five (``tests/test_torch_solve.py`` checks it against
    ``torch.func.jvp``)."""
    corners = box3d_corners(state[:, :3], dims_hwl, state[:, 3])  # [N, 8, 3]
    x, y, z = corners.unbind(-1)
    # d corner / d (x, y, z, theta): translation is the identity; the yaw
    # derivative of the rotated template (c * xo + s * zo, -s * xo + c * zo).
    w, l = dims_hwl[:, 1:2], dims_hwl[:, 2:3]
    xo = torch.cat([k * l for k in _CORNERS_X], dim=1)
    zo = torch.cat([k * w for k in _CORNERS_Z], dim=1)
    c = torch.cos(state[:, 3:4])
    s = torch.sin(state[:, 3:4])
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    dx = torch.stack([one, zero, zero, -s * xo + c * zo], dim=-1)
    dy = torch.stack([zero, one, zero, zero], dim=-1)
    dz = torch.stack([zero, zero, one, -c * xo - s * zo], dim=-1)
    cal8 = _per_corner(calib)
    u_l, v_l, du_l, dv_l = _project_jac((x, y, z), (dx, dy, dz), cal8, False)
    u_r, _, du_r, _ = _project_jac((x, y, z), (dx, dy, dz), cal8, True)
    k = kpt_idx.long()[:, None]
    cols = [_extreme(u_l, du_l, False), _extreme(v_l, dv_l, False),
            _extreme(u_l, du_l, True), _extreme(v_l, dv_l, True),
            _extreme(u_r, du_r, False), _extreme(u_r, du_r, True),
            (torch.gather(u_l, 1, k)[:, 0],
             torch.gather(du_l, 1, k[..., None].expand(-1, 1, 4))[:, 0])]
    return (torch.stack([v for v, _ in cols], dim=-1),
            torch.stack([d for _, d in cols], dim=1))


def _init_state(obs: torch.Tensor, alpha: torch.Tensor,
                calib: StereoCalib) -> torch.Tensor:
    """Closed-form init [N, 4] from box-center disparity."""
    ul, vt, ur, vb, ul_r, ur_r = (obs[:, i] for i in range(6))
    uc_l = 0.5 * (ul + ur)
    uc_r = 0.5 * (ul_r + ur_r)
    disp = torch.clamp(uc_l - uc_r, min=1.0)
    z0 = calib.f * calib.baseline / disp
    x0 = (uc_l - calib.cu) * z0 / calib.f - calib.tx2
    y0 = (vb - calib.cv) * z0 / calib.f
    theta0 = alpha + torch.atan2(x0, z0)
    return torch.stack([x0, y0, z0, theta0], dim=-1)


def _solve_spd4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 SPD solve by unrolled Cholesky: a [N, 4, 4], b [N, 4]."""
    n = 4
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[:, i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def solve_batch_ref(obs: torch.Tensor, dims_hwl: torch.Tensor,
                    alpha: torch.Tensor, kpt_idx: torch.Tensor,
                    calib: StereoCalib,
                    obs_weights: torch.Tensor | None = None,
                    iters: int = 30, damping: float = 1e-3,
                    fixed_z: torch.Tensor | None = None) -> SolveResult:
    """The plain loop of :func:`solve_batch`: its CPU path, and what K5 is
    held to."""
    nd = obs.shape[0]
    dev = obs.device
    if obs_weights is None:
        obs_weights = torch.ones((nd, 7), device=dev)

    state = _init_state(obs, alpha, calib)
    free = torch.ones((nd, 4), device=dev)
    if fixed_z is not None:
        state = torch.cat([state[:, :2], fixed_z[:, None], state[:, 3:]],
                          dim=1)
        free[:, 2] = 0.0

    def residual(s):
        pred, jac = _observe_jac(s, dims_hwl, kpt_idx, calib)
        return (pred - obs) * obs_weights, jac * obs_weights[..., None]

    eye4 = torch.eye(4, device=dev)
    # Trust region: per-iteration update bound (m, m, m, rad).
    max_step = torch.tensor([3.0, 1.5, 5.0, 0.5], device=dev)
    for _ in range(iters):
        r, j = residual(state)                              # [N, 7], [N, 7, 4]
        j = j * free[:, None, :]
        jtj = torch.einsum("nik,nil->nkl", j, j)
        diag = torch.diagonal(jtj, dim1=1, dim2=2)          # [N, 4]
        jtj = (jtj + (damping * (1.0 + diag))[:, :, None] * eye4 +
               eye4 * (1.0 - free)[:, None, :])
        jtr = torch.einsum("nik,ni->nk", j, r)
        delta = torch.clamp(_solve_spd4(jtj, jtr), -max_step, max_step)
        new = state - delta * free
        # Keep depth physical: z <= ~0 breaks the projection.
        state = torch.cat([new[:, :2], torch.clamp(new[:, 2:3], min=0.5),
                           new[:, 3:]], dim=1)
    r = residual(state)[0]
    return SolveResult(position=state[:, :3], theta=state[:, 3],
                       residual=torch.sqrt(torch.mean(r ** 2, dim=-1)))


_P = ctypes.c_void_p
_I = ctypes.c_int


class GaussNewtonSolveKernel(CudaKernel):
    """K5: ``gauss_newton_solve``, the whole of :func:`solve_batch_ref` in
    one launch, one thread per detection."""

    source = "box_solve.cu"
    symbol = "gauss_newton_solve"
    argtypes = [_P] * 14 + [_I, _I, ctypes.c_float, _P]

    def __call__(self, obs, obs_weights, dims_hwl, alpha, kpt_idx, f, cu, cv,
                 baseline, tx2, fixed_z, iters: int, damping: float):
        """``(position [N, 3], theta [N], residual [N])`` float32 for
        contiguous float32 ``obs`` and ``obs_weights`` [N, 7], ``dims_hwl``
        [N, 3], ``alpha``, the five calibration fields and ``fixed_z``
        (or None) [N], and int32 ``kpt_idx`` [N], all on one card."""
        n = obs.shape[0]
        dev = obs.device
        if iters < 0:
            raise ValueError(f"iters must be >= 0, got {iters}")
        args = dict(obs=obs, obs_weights=obs_weights, dims_hwl=dims_hwl,
                    alpha=alpha, kpt_idx=kpt_idx, f=f, cu=cu, cv=cv,
                    baseline=baseline, tx2=tx2, fixed_z=fixed_z)
        shapes = dict(obs=(n, 7), obs_weights=(n, 7), dims_hwl=(n, 3))
        for name, t in args.items():
            if t is None:           # fixed_z: z is free
                continue
            shape = shapes.get(name, (n,))
            dtype = torch.int32 if name == "kpt_idx" else torch.float32
            if (t.shape != shape or t.dtype != dtype or t.device != dev or
                    not t.is_contiguous()):
                raise ValueError(f"{name} must be contiguous {dtype} "
                                 f"{list(shape)} on {dev}, got {t.dtype} "
                                 f"{list(t.shape)} on {t.device}")
        position = torch.empty((n, 3), dtype=torch.float32, device=dev)
        theta = torch.empty((n,), dtype=torch.float32, device=dev)
        residual = torch.empty((n,), dtype=torch.float32, device=dev)
        if n == 0:
            return position, theta, residual
        self.launch(dev, *[None if t is None else t.data_ptr()
                           for t in args.values()],
                    position.data_ptr(), theta.data_ptr(),
                    residual.data_ptr(), n, iters, damping)
        return position, theta, residual


gauss_newton_solve_kernel = GaussNewtonSolveKernel()


def _solve_plain(obs, obs_weights, dims_hwl, alpha, kpt_idx, f, cu, cv,
                 baseline, tx2, fixed_z, iters, damping):
    # solve_batch_ref looked up by name at each call, so that a wrapper put
    # in its place sees every call; copies, as an op's outputs may not
    # alias its inputs.
    res = solve_batch_ref(obs, dims_hwl, alpha, kpt_idx,
                          StereoCalib(f, cu, cv, baseline, tx2, None, None),
                          obs_weights, iters, damping, fixed_z)
    return res.position.clone(), res.theta.clone(), res.residual


def _solve_fake(obs, obs_weights, dims_hwl, alpha, kpt_idx, f, cu, cv,
                baseline, tx2, fixed_z, iters, damping):
    n = obs.shape[0]
    return (obs.new_empty((n, 3)), obs.new_empty((n,)),
            obs.new_empty((n,)))


# The solve as a registered op, so that ``torch.export`` keeps it as one
# graph node rather than its loop unrolled.
gauss_newton_solve = kernel_op(
    "gauss_newton_solve",
    "(Tensor obs, Tensor obs_weights, Tensor dims_hwl, Tensor alpha, "
    "Tensor kpt_idx, Tensor f, Tensor cu, Tensor cv, Tensor baseline, "
    "Tensor tx2, Tensor? fixed_z, int iters, float damping) -> "
    "(Tensor, Tensor, Tensor)",
    gauss_newton_solve_kernel, _solve_plain, _solve_fake)


def solve_batch(obs: torch.Tensor, dims_hwl: torch.Tensor,
                alpha: torch.Tensor, kpt_idx: torch.Tensor,
                calib: StereoCalib, obs_weights: torch.Tensor | None = None,
                iters: int = 30, damping: float = 1e-3,
                fixed_z: torch.Tensor | None = None) -> SolveResult:
    """Solve [N] detections' poses in float32; ``fixed_z`` freezes z (the
    re-solve after dense alignment).  One launch of K5 on CUDA tensors, the
    plain loop on CPU tensors."""
    nd = obs.shape[0]
    dev = obs.device

    def f32(x):
        return x.to(dev, torch.float32).contiguous()

    def per_det(v):             # a calibration field: [N], 0-d or a number
        if torch.is_tensor(v):
            return f32(v.expand(nd))
        return torch.full((nd,), float(v), device=dev)

    if obs_weights is None:
        obs_weights = torch.ones((nd, 7), device=dev)
    return SolveResult(*gauss_newton_solve(
        f32(obs), f32(obs_weights), f32(dims_hwl), f32(alpha),
        kpt_idx.to(dev, torch.int32).contiguous(),
        *[per_det(v) for v in calib[:5]],
        None if fixed_z is None else f32(fixed_z), iters, damping))


def solve_pose(obs: torch.Tensor, dims_hwl: torch.Tensor, alpha, kpt_idx,
               calib: StereoCalib, obs_weights: torch.Tensor | None = None,
               iters: int = 30, damping: float = 1e-3,
               fixed_z=None) -> SolveResult:
    """One detection (obs [7], dims [3], scalar alpha, kpt_idx and
    fixed_z) through :func:`solve_batch`; ``calib`` holds one
    calibration (numbers or 0-d tensors)."""
    dev = obs.device

    def one(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)[None]

    res = solve_batch(
        obs[None], dims_hwl[None], one(alpha, obs.dtype), one(kpt_idx),
        calib, obs_weights=None if obs_weights is None else obs_weights[None],
        iters=iters, damping=damping,
        fixed_z=None if fixed_z is None else one(fixed_z, obs.dtype))
    return SolveResult(position=res.position[0], theta=res.theta[0],
                       residual=res.residual[0])


def observations_from_detection(box_left: torch.Tensor,
                                box_right: torch.Tensor,
                                kpt_u: torch.Tensor) -> torch.Tensor:
    """Pack network outputs into the solver's [.., 7] observation vector."""
    return torch.stack([
        box_left[..., 0], box_left[..., 1], box_left[..., 2],
        box_left[..., 3], box_right[..., 0], box_right[..., 2], kpt_u,
    ], dim=-1)
