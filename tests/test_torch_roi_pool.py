"""``stereo_rcnn_tpu_torch.ops.roi_pool`` against the JAX package's
``roi_pool``: the twins of ``tests/test_roi_pool.py``, and equality on
seeded inputs (exact: a max over the same gathered taps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.ops.roi_pool import roi_pool as j_roi_pool
from stereo_rcnn_tpu_torch.ops.roi_pool import roi_pool


def test_roi_pool_max_semantics():
    feat = torch.zeros(16, 16, 1)
    feat[5, 5, 0] = 9.0
    feat[10, 12, 0] = 4.0
    rois = torch.tensor([[0.0, 0.0, 16.0, 16.0]])
    out = roi_pool(feat, rois, output_size=2, spatial_scale=1.0,
                   samples_per_bin=8)
    # Peak 9 is in the top-left quadrant, peak 4 in the bottom-right.
    assert float(out[0, 0, 0, 0]) == 9.0
    assert float(out[0, 1, 1, 0]) == 4.0
    assert float(out[0, 0, 1, 0]) == 0.0


def test_roi_pool_constant():
    feat = torch.full((8, 8, 4), 2.5)
    rois = torch.tensor([[1.0, 1.0, 7.0, 7.0]])
    out = roi_pool(feat, rois, 3, 1.0)
    np.testing.assert_allclose(out.numpy(), 2.5)


@pytest.mark.parametrize("p, s, scale", [(7, 4, 0.25), (3, 2, 0.125),
                                         (2, 8, 1.0)])
def test_roi_pool_matches_jax(p, s, scale):
    """Random features and rois (inside, across and beyond the map, some
    under one cell), the same output bit for bit."""
    rng = np.random.RandomState(p * 10 + s)
    feat = rng.randn(24, 40, 5).astype(np.float32)
    xy = rng.uniform(-40, [40 / scale, 24 / scale], size=(30, 2))
    wh = rng.uniform(0, [30 / scale, 20 / scale], size=(30, 2))
    rois = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    theirs = np.asarray(j_roi_pool(jnp.asarray(feat), jnp.asarray(rois), p,
                                   scale, s))
    ours = roi_pool(torch.from_numpy(feat), torch.from_numpy(rois), p, scale,
                    s)
    assert ours.shape == theirs.shape == (30, p, p, 5)
    np.testing.assert_array_equal(ours.numpy(), theirs)
