"""K2, the fused stereo RoIAlign's backward, in the training step: the
bytes of the traced launches from their shapes (``work.roi_align_bytes.
k2_bytes``, every roi valid) at the card's HBM rate, over their summed
device time (%)."""

from h100_bench.work.roi_align_bytes import k2_bytes

K2 = r"\bstereo_roi_align_bwd_kernel[<(]"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    times = tr.kernel_times(K2)
    if not times:
        return None
    cfg = ctx["cfg"]
    n_bytes = len(times) * k2_bytes(
        ctx["pairs_per_step"], cfg.rcnn.rois_per_image, cfg.backbone.fpn_dim,
        (cfg.data.image_h, cfg.data.image_w))
    return 100.0 * n_bytes / ctx["peaks"]["hbm_bytes_per_s"] / sum(times)
