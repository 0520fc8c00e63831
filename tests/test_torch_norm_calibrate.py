"""GroupNorm -> calibrated frozen-affine conversion in the port
(``convert/norm_calibrate.py``, ``tools/calibrate_norm.py``), on the CPU at
the tiny float32 GroupNorm config, its weights the JAX session fixture's
through ``convert.from_jax``.

The twins of ``tests/test_norm_calibrate.py`` (a single calibration image
reproduces the GroupNorm backbone to 5e-5 of each level's largest value;
the calibrated tree is the frozen model's; a site without statistics
raises), then parity with the JAX module: the captured moments to 1e-5 of
each site's largest (the two backbones' float32 activations differ in
their last bits), and the fold of the same statistics exactly (the same
float32 operations).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from stereo_rcnn_tpu.convert import norm_calibrate as j_nc
from stereo_rcnn_tpu.models import build_model as j_build_model
from stereo_rcnn_tpu.models import init_params as j_init_params
from stereo_rcnn_tpu_torch.config import (load_config, save_config,
                                          tiny_test_config)
from stereo_rcnn_tpu_torch.convert.from_jax import (_flatten, _module_rule,
                                                    state_dict_from_jax)
from stereo_rcnn_tpu_torch.convert.norm_calibrate import (
    calibrate, capture_norm_stats, fold_group_norms)
from stereo_rcnn_tpu_torch.data.synthetic import synthetic_batch
from stereo_rcnn_tpu_torch.models.detector import build_model
from stereo_rcnn_tpu_torch.tools import calibrate_norm
from stereo_rcnn_tpu_torch.train.checkpoint import (export_params,
                                                    restore_params)


def _frozen(cfg):
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, norm="frozen"))


@pytest.fixture(scope="module")
def port(tiny_params):
    cfg = dataclasses.replace(tiny_test_config(), compute_dtype="float32")
    params = jax.tree.map(np.asarray, tiny_params)
    model = build_model(cfg).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    h, w = cfg.data.image_h, cfg.data.image_w
    img = np.random.RandomState(3).rand(1, h, w, 3).astype(np.float32) * 255
    return cfg, params, model, img


@pytest.fixture(scope="module")
def calibrated(port):
    cfg, _, model, img = port
    t = torch.from_numpy(img)
    cfg_aff, model_aff = calibrate(cfg, model, [(t, t)])
    return cfg_aff, model_aff


def test_single_image_calibration_is_exact(port, calibrated):
    cfg, _, model, img = port
    cfg_aff, model_aff = calibrated
    assert cfg_aff.backbone.norm == "frozen"
    with torch.no_grad():
        feats_gn = model.backbone(torch.from_numpy(img))
        feats_aff = model_aff.backbone(torch.from_numpy(img))
    for lvl, (a, b) in enumerate(zip(feats_gn, feats_aff)):
        err = (a.float() - b.float()).abs().max().item()
        scale = a.float().abs().max().item() + 1e-6
        assert err / scale < 5e-5, (lvl, err, scale)


def test_calibrated_tree_matches_frozen_init(calibrated):
    cfg_aff, model_aff = calibrated
    ours = model_aff.state_dict()
    tmpl = build_model(cfg_aff).state_dict()
    assert list(ours) == list(tmpl)
    for k in tmpl:
        assert ours[k].shape == tmpl[k].shape, k
        assert ours[k].dtype == tmpl[k].dtype, k


def test_fold_requires_stats_for_every_site(port):
    cfg, _, model, _ = port
    tmpl = build_model(_frozen(cfg)).state_dict()
    with pytest.raises(KeyError):
        fold_group_norms(model.state_dict(), {}, tmpl)


def _jax_stats_to_port(stats):
    """The JAX capture's ``{site path: {"mu", "var"}}`` under the port's
    module names."""
    out = {}
    for path, value in _flatten(stats).items():
        site, moment = path.rsplit("/", 1)
        prefix, kind = _module_rule(site)
        assert kind == "bn", path
        out.setdefault(prefix, {})[moment] = torch.from_numpy(
            np.array(value, np.float32))
    return out


@pytest.fixture(scope="module")
def jax_stats(port, tiny_params, tiny_cfg_f32):
    """Two images a side, so the moments pool over a batch."""
    cfg, _, _, _ = port
    h, w = cfg.data.image_h, cfg.data.image_w
    rng = np.random.RandomState(4)
    il = rng.rand(2, h, w, 3).astype(np.float32) * 255
    ir = rng.rand(2, h, w, 3).astype(np.float32) * 255
    stats = j_nc.capture_norm_stats(j_build_model(tiny_cfg_f32), tiny_params,
                                    [(il, ir)])
    return il, ir, _jax_stats_to_port(jax.tree.map(np.asarray, stats))


def test_capture_matches_jax(port, jax_stats):
    _, _, model, _ = port
    il, ir, theirs = jax_stats
    ours = capture_norm_stats(model, [(torch.from_numpy(il),
                                       torch.from_numpy(ir))])
    assert set(ours) == set(theirs)
    assert len(ours) == sum(1 for k in model.state_dict()
                            if k.endswith(".gn.weight"))
    for site in theirs:
        for moment in ("mu", "var"):
            a, b = ours[site][moment], theirs[site][moment]
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() <= 1e-5 * scale, (site, moment)


def test_fold_matches_jax_fold(port, jax_stats, tiny_params, tiny_cfg_f32):
    """The same statistics folded by both packages: equal bit for bit
    (both multiply by the reciprocal root, as XLA rewrites the JAX
    module's division by a root)."""
    cfg, params, model, _ = port
    stats_np = j_nc.capture_norm_stats(
        j_build_model(tiny_cfg_f32), tiny_params,
        [(jax_stats[0], jax_stats[1])])
    cfg_aff_j = tiny_cfg_f32.replace(backbone=dataclasses.replace(
        tiny_cfg_f32.backbone, norm="frozen"))
    tmpl_j = j_init_params(cfg_aff_j, jax.random.PRNGKey(0))
    folded_j = j_nc.fold_group_norms(tiny_params["params"], stats_np,
                                     tmpl_j["params"])
    theirs = state_dict_from_jax(jax.tree.map(np.asarray, folded_j),
                                 _frozen(cfg))
    ours = fold_group_norms(
        model.state_dict(),
        _jax_stats_to_port(jax.tree.map(np.asarray, stats_np)),
        build_model(_frozen(cfg)).state_dict())
    assert set(ours) == set(theirs)
    for k in theirs:
        assert torch.equal(ours[k], theirs[k]), k


def test_calibrate_norm_tool_end_to_end(port, tmp_path, capsys):
    """A gate nothing passes writes nothing (rc 1); gates everything passes
    write the export, its config and the VALID marker, holding what
    ``calibrate`` gives on the tool's calibration scenes."""
    cfg, _, model, _ = port
    ckpt = str(tmp_path / "ckpt")
    export_params(os.path.join(ckpt, "params_export"), model)
    save_config(cfg, os.path.join(ckpt, "config.json"))
    common = ["--ckpt-dir", ckpt, "--calib-batches", "1", "--eval-batches",
              "1", "--batch", "2", "--platform", "cpu"]
    out_dir = os.path.join(ckpt, "calibrated")

    assert calibrate_norm.main(common + ["--min-iou", "1.1"]) == 1
    assert "validation FAILED" in capsys.readouterr().out
    assert not os.path.exists(out_dir)

    assert calibrate_norm.main(common + [
        "--min-iou", "0", "--max-z-drift", "1e9",
        "--max-count-drift", "1e9"]) == 0
    assert "wrote" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out_dir, "VALID"))
    cfg_aff = load_config(os.path.join(out_dir, "config.json"))
    assert cfg_aff.backbone.norm == "frozen"
    written = restore_params(os.path.join(out_dir, "params_export"),
                             build_model(cfg_aff)).state_dict()
    il, ir, _, _ = synthetic_batch(cfg, batch=2, seed=5000)
    _, expected = calibrate(cfg, model, [(torch.from_numpy(il),
                                          torch.from_numpy(ir))])
    for k, v in expected.state_dict().items():
        assert torch.equal(written[k], v), k
