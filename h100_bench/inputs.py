"""The inputs of a run, all made from ``--seed``: sub-seeds, the pool of
rendered stereo pairs (the frozen renderer of ``reference/data``) and the
weights."""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from h100_bench.reference.config import Config
from h100_bench.reference.data.synthetic import random_scene, render_pair
from h100_bench.reference.geometry.calib import (StereoCalib,
                                                 default_kitti_calib)

#: Sub-seed tags.
WEIGHTS, POOL = 1, 2


def sub_seed(seed: int, tag: int, index: int = 0) -> int:
    """A 63-bit seed for one use of the run's ``seed`` (any integer)."""
    ss = np.random.SeedSequence([seed % (1 << 64), tag, index])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


@dataclasses.dataclass
class Pool:
    left: np.ndarray         # [N, H, W, 3] mean-subtracted BGR, float32
    right: np.ndarray
    calib: StereoCalib       # the working-resolution calibration


def working_calib(cfg: Config) -> StereoCalib:
    h, w = cfg.data.image_h, cfg.data.image_w
    return default_kitti_calib().scale(min(w / 1242.0, h / 375.0))


def render_pool(cfg: Config, pairs: int, objects: int, seed: int,
                threads: int = 4) -> Pool:
    """``pairs`` scenes of ``objects`` cars each; pair ``i`` is drawn from
    its own stream, so the pool does not depend on ``threads``."""
    calib = working_calib(cfg)
    h, w = cfg.data.image_h, cfg.data.image_w
    means = np.asarray(cfg.backbone.pixel_means_bgr, np.float32)
    classes = tuple(cfg.data.classes[1:])

    def one(i):
        rng = np.random.RandomState(sub_seed(seed, POOL, i) % (1 << 32))
        objs = random_scene(rng, objects, calib, h, w, classes)
        il, ir = render_pair(objs, calib, h, w, rng,
                             appearance=cfg.data.synthetic_appearance)
        return il - means, ir - means

    with ThreadPoolExecutor(threads) as ex:
        done = list(ex.map(one, range(pairs)))
    return Pool(left=np.stack([d[0] for d in done]),
                right=np.stack([d[1] for d in done]),
                calib=calib)


def make_weights(cfg: Config, seed: int, device, pool: "Pool",
                 class_head=None):
    """``(state_dict, class_head, balance_s)``: the run's weights from
    ``seed``, the class kernel's scale and bias balanced on the pool's
    first pair unless given (the reference's copy of the weights is given
    what set-up found), and the seconds the balance took (the reference
    computes it, so a run leaves them out of its set-up time)."""
    from h100_bench.reference.weights import (apply_class_head,
                                              balance_class_head,
                                              make_state_dict)
    sd = make_state_dict(cfg, sub_seed(seed, WEIGHTS), device)
    balance_s = 0.0
    if class_head is None:
        t0 = time.perf_counter()
        class_head = balance_class_head(
            cfg, sd, torch.from_numpy(pool.left[:1]).to(device),
            torch.from_numpy(pool.right[:1]).to(device))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        balance_s = time.perf_counter() - t0
    return apply_class_head(sd, *class_head), class_head, balance_s
