"""The backbone's folded forward (``models/resnet_fpn.py``): with no
gradient and a frozen or affine norm, each norm's scale is folded into the
convolution's weights once and each convolution is followed by one
epilogue (bias, residual, ReLU; ``ops/conv_epilogue.py``, whose plain
version runs here).  Held to the unfolded forward, site by site and whole,
with random non-identity scales and biases at every norm; the folded
weights are built once per set of weights and rebuilt when one changes;
nothing is folded under grad or for GroupNorm; the ``state_dict`` is
untouched.  Tiny shapes (ResNet-26, FPN 16): a few seconds in all.
"""

import gc
import weakref

import pytest
import torch

from stereo_rcnn_tpu_torch.models import resnet_fpn as rf
from tests.torch_threads import one_torch_thread  # noqa: F401

CL = torch.channels_last
# Float32: the folded and unfolded sites differ only in where the scale
# multiplies (the weights or the convolution's sums): 1e-5 of the largest
# value.
TOL_F32 = 1e-5
# bfloat16 (8 significant bits: a rounding moves a value by at most 2^-8
# of it): the unfolded site rounds the convolution's output, its product
# by the scale and the sum with the bias (in a block also the residual
# sum), the folded one the folded weights and the epilogue's result.  The
# two are at most 6 roundings apart, under 2^-5 of the largest value
# (measured: up to 2^-6.7 of it, at the stem, over 3 seeds).
TOL_BF16 = 2.0 ** -5


def _model(norm="frozen", seed=0):
    """ResNet-26 + FPN 16 with random norm scales (0.5 to 1.5) and biases
    at every site."""
    torch.manual_seed(seed)
    m = rf.ResNetFPN(depth=26, fpn_dim=16, norm=norm).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, rf.FrozenBatchNorm):
                mod.scale.copy_(torch.rand(mod.scale.shape, generator=g)
                                + 0.5)
                mod.bias.copy_(0.5 * torch.randn(mod.bias.shape,
                                                 generator=g))
    return m


@pytest.fixture(scope="module")
def model():
    return _model()


def _x(shape, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(
        memory_format=CL)


def _site(model, site, dtype):
    """``(unfolded, folded)`` outputs of one site under no_grad."""
    fb = model.fold(dtype)
    if site == "stem":
        x = _x((2, 3, 32, 48), dtype)
        return model.RCNN_layer0(x), rf.stem_folded(x, fb.stem)
    if site in ("downsample_block", "identity_block"):
        b = 0 if site == "downsample_block" else 1
        x = _x((2, 256 * (1 + b), 16 // (1 + b), 24 // (1 + b)), dtype)
        block = model.RCNN_layer2[b]
        assert (block.downsample is None) == (b == 1)
        return block(x), rf.bottleneck_folded(x, fb.stages[1][b])
    stages = [_x((2, c, 16 // 2 ** i, 24 // 2 ** i), dtype, seed=i)
              for i, c in enumerate((256, 512, 1024, 2048))]
    return (torch.cat([p.flatten() for p in model.fpn(stages)]),
            torch.cat([p.flatten() for p in rf.fpn_folded(stages, fb,
                                                          "bilinear")]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", ["stem", "downsample_block",
                                  "identity_block", "fpn"])
def test_folded_site_matches_unfolded(model, site, dtype):
    """Each kind of site, folded, against its unfolded modules: the stem
    (conv, norm, ReLU, max-pool), a stride-2 bottleneck with a downsample
    (whose bias joins bn3's), an identity bottleneck, and the FPN (biases
    in the epilogue, the upsampled level as the laterals' residual)."""
    with torch.no_grad():
        ref, got = _site(model, site, dtype)
    assert got.dtype == dtype and got.shape == ref.shape
    tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (site, err)


@pytest.mark.parametrize("norm", ["frozen", "affine"])
def test_folded_backbone_matches_unfolded(norm):
    """The whole forward with no gradient (folded) against the forward
    under grad (unfolded, today's code), float32, level by level; the
    folded levels are contiguous NHWC as the unfolded ones."""
    m = _model(norm)
    images = torch.rand(2, 64, 96, 3) * 255.0
    with torch.no_grad():
        got = m(images, torch.float32)
    ref = m(images, torch.float32)
    assert m.fold_builds == 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.is_contiguous()
        r = r.detach()
        assert (g - r).abs().max().item() <= TOL_F32 * r.abs().max().item()


def test_fold_is_built_once_and_rebuilt_when_a_source_changes():
    """One build over three calls; a rebuild after ``load_state_dict(...,
    assign=True)`` and after an in-place ``scale.mul_``, each giving the
    unfolded forward of the new weights; another dtype is another build;
    the forward under grad builds nothing."""
    m = _model(seed=2)
    images = torch.rand(1, 32, 64, 3) * 255.0

    def check(builds):
        with torch.no_grad():
            for _ in range(3):
                got = m(images, torch.float32)
        assert m.fold_builds == builds
        ref = m(images, torch.float32)
        assert m.fold_builds == builds
        for g, r in zip(got, ref):
            r = r.detach()
            assert (g - r).abs().max() <= TOL_F32 * r.abs().max()

    check(1)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    sd["RCNN_layer1.0.bn1.bias"] += 1.0
    sd["RCNN_smooth3.weight"] *= 2.0
    m.load_state_dict(sd, assign=True)
    check(2)
    with torch.no_grad():
        m.RCNN_layer3[1].bn2.scale.mul_(1.5)
    check(3)
    with torch.no_grad():
        m(images, torch.bfloat16)
    assert m.fold_builds == 4


def test_fold_follows_replaced_modules_and_keeps_no_old_weights():
    """A submodule replaced after construction is folded from its own
    tensors at the next call; the kept build holds no source tensor (a
    parameter replaced by ``load_state_dict(..., assign=True)`` is freed);
    ``.to()`` drops the folded copy at once."""
    m = _model(seed=3)
    images = torch.rand(1, 32, 64, 3) * 255.0

    def check(builds):
        with torch.no_grad():
            got = m(images, torch.float32)
        assert m.fold_builds == builds
        ref = m(images, torch.float32)
        for g, r in zip(got, ref):
            r = r.detach()
            assert (g - r).abs().max() <= TOL_F32 * r.abs().max()

    check(1)
    norm = rf.FrozenBatchNorm(m.RCNN_layer2[0].bn2.scale.numel())
    with torch.no_grad():
        norm.scale.fill_(0.25)
        norm.bias.fill_(-1.0)
    m.RCNN_layer2[0].bn2 = norm
    check(2)
    m.RCNN_smooth1 = rf.Conv2d(16, 16, 3, padding=1)
    check(3)
    old = weakref.ref(m.RCNN_layer4[0].conv2.weight)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    m.load_state_dict(sd, assign=True)
    gc.collect()
    assert old() is None
    check(4)
    with torch.no_grad():
        m(images, torch.float32)
    folded = weakref.ref(m._fold.sites.stem.weight)
    m.to(torch.device("cpu"))
    gc.collect()
    assert m._fold is None and folded() is None
    check(5)


def test_no_fold_under_grad_or_for_group_norm():
    """GroupNorm (no_grad or not) and any norm under grad take the
    unfolded forward: nothing is built."""
    images = torch.rand(1, 32, 64, 3) * 255.0
    g = rf.ResNetFPN(depth=26, fpn_dim=16, norm="group").eval()
    with torch.no_grad():
        g(images, torch.float32)
    f = _model()
    f(images, torch.float32)
    assert g.fold_builds == f.fold_builds == 0
    assert g._fold is None and f._fold is None


def test_state_dict_is_untouched_by_the_fold(model):
    """The folded weights are plain attributes: the ``state_dict``'s keys
    (the upstream names) and values, and the buffers, are as before."""
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n_buffers = len(list(model.buffers()))
    with torch.no_grad():
        model(torch.rand(1, 32, 64, 3), torch.float32)
    assert model._fold is not None
    after = model.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert len(list(model.buffers())) == n_buffers
