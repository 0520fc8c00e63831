"""Host input pipeline: decode -> resize/normalize (native) -> batch ->
prefetch.

Port of ``stereo_rcnn_tpu.data.pipeline`` (numpy only; the JAX package's
``jax.tree.map`` over the calibration is a field-wise stack here).  A
background thread keeps ``prefetch`` batches in flight so host
preprocessing overlaps the card's work; the per-pixel resize runs in the
native ``csrc/host_preproc.cpp`` (``utils.host_preproc``).  A worker's
exception is raised in the consuming thread, and closing the iterator
early stops the worker.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from stereo_rcnn_tpu_torch.config import Config
from stereo_rcnn_tpu_torch.data.kitti import KittiDataset, pack_ground_truth
from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
from stereo_rcnn_tpu_torch.train.targets import GroundTruth
from stereo_rcnn_tpu_torch.utils.host_preproc import resize_subtract_pad


class PipelineBatch(NamedTuple):
    """One host-side batch.  The last batch of an epoch may be padded with
    wrap-around frames from the epoch order: ``n_valid`` <= B gives the
    real frame count (consumers must not score the pad replicas)."""

    images_left: np.ndarray    # [B, H, W, 3]
    images_right: np.ndarray   # [B, H, W, 3]
    gt: GroundTruth            # leaves [B, G, ...]
    scales: np.ndarray         # [B] image resize factor
    calib: StereoCalib         # leaves [B, ...] — working-resolution calib
    n_valid: int               # real (non-pad) frames in this batch
    content_wh: np.ndarray = None  # [B, 2] letterboxed content extent
    #  (w, h) in working-resolution px: smaller than the padded canvas when
    #  the source aspect ratio differs (KITTI 1242x375 in a 1280x384 canvas
    #  leaves ~8 px of right padding).


def load_image(path: str) -> np.ndarray:
    """uint8 [H, W, 3] BGR.  ``.npy`` needs no codec; other formats need
    cv2 or PIL."""
    if path.endswith(".npy"):
        arr = np.load(path)
        return np.clip(arr, 0, 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)      # BGR already
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot decode {path}: neither cv2 nor PIL is installed; "
            "write the images as .npy and pass --image-ext .npy") from None
    rgb = np.asarray(Image.open(path).convert("RGB"))
    return rgb[..., ::-1].copy()                      # -> BGR


class KittiPipeline:
    """Iterates :class:`PipelineBatch` es over one epoch of a
    :class:`KittiDataset`."""

    def __init__(self, cfg: Config, dataset: KittiDataset, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 image_ext: str = ".png", prefetch: int = 2):
        self.cfg = cfg
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.image_ext = image_ext
        self.prefetch = prefetch

    def _load_example(self, idx: int):
        cfg = self.cfg
        p = self.ds.paths(idx)
        img_l = load_image(p["left"].replace(".png", self.image_ext))
        img_r = load_image(p["right"].replace(".png", self.image_ext))
        sh, sw = img_l.shape[:2]
        th, tw = cfg.data.image_h, cfg.data.image_w
        scale = min(th / sh, tw / sw)
        means = cfg.backbone.pixel_means_bgr
        out_l = resize_subtract_pad(img_l, th, tw, scale, means)
        out_r = resize_subtract_pad(img_r, th, tw, scale, means)
        annos, calib = self.ds.load_annotation(idx, float(sw))
        gt = pack_ground_truth(annos, cfg.train.max_gt_boxes, scale=scale)
        # The working-resolution calibration rides with the example (real
        # KITTI calibration varies per frame).
        calib_s = StereoCalib(*[np.asarray(v) for v in calib.scale(scale)])
        content = np.asarray([sw * scale, sh * scale], np.float32)
        return out_l, out_r, gt, scale, calib_s, content

    def _epoch_indices(self):
        """[n_batches, B] index array and per-batch valid counts.  The
        ragged tail is padded to a full batch with wrap-around frames from
        the start of this epoch's (shuffled) order; its true length rides
        in ``n_valid``."""
        idx = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(idx)
        bs = self.batch_size
        n_full = len(idx) // bs
        tail = len(idx) - n_full * bs
        counts = [bs] * n_full
        if tail:
            pad = np.resize(idx, len(idx) + bs - tail)[len(idx):]
            idx = np.concatenate([idx, pad])
            counts.append(tail)
        return idx.reshape(-1, bs), counts

    def _make_batch(self, indices: Sequence[int], n_valid: int):
        ex = [self._load_example(int(i)) for i in indices]
        return PipelineBatch(
            images_left=np.stack([e[0] for e in ex]),
            images_right=np.stack([e[1] for e in ex]),
            gt=GroundTruth(*[np.stack(field)
                             for field in zip(*[e[2] for e in ex])]),
            scales=np.asarray([e[3] for e in ex], np.float32),
            calib=StereoCalib(*[np.stack(field)
                                for field in zip(*[e[4] for e in ex])]),
            n_valid=n_valid,
            content_wh=np.stack([e[5] for e in ex]))

    def __iter__(self) -> Iterator[PipelineBatch]:
        """Background-threaded prefetching iterator over one epoch."""
        batches, counts = self._epoch_indices()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for b, n in zip(batches, counts):
                    if not put(self._make_batch(b, n)):
                        return
                put(done)
            except Exception as e:  # noqa: BLE001 — raised by the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def steps_per_epoch(self) -> int:
        """Batches per epoch (including a padded tail batch, if any)."""
        return -(-len(self.ds) // self.batch_size)
