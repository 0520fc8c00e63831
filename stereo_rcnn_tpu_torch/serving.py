"""Ahead-of-time export of the whole inference pipeline (``torch.export``).

Port of ``stereo_rcnn_tpu.serving``.  :func:`export_pipeline` traces
``inference.make_full_pipeline`` (network, NMS, batched 3D solve, dense
alignment) into one ``torch.export`` program and returns it as bytes; a
serving process needs only :func:`load_pipeline`, which builds no model:
the program is the model.  Each hand-written kernel on the pipeline's
path is a registered op ``stereo_rcnn_tpu_torch::<name>``
(``ops/cuda_build.kernel_op``), each call kept as one graph node that
dispatches by device at run time (the kernel on the card, its plain
version on the CPU).  The module that defines a kernel registers its op
when it is imported, and the pipeline imports every one it calls; so this
module imports the pipeline it serves (``inference``), and every op a
loaded program calls is registered before ``torch.export.load``.

Differences from the JAX artifact:

* The artifact holds the weights it was traced with (the JAX one holds
  none): ``Config()`` (ResNet-101) at batch 8 is 446.8 MB, as
  ``chip_smoke.py``'s serving phase measured it on an NVIDIA H100 80GB
  HBM3 at a 700 W power limit (``PERF.md`` §5).  Weights are still a
  run-time input: :meth:`ExportedPipeline.load_state_dict` loads any
  ``state_dict`` of the same config (a params export) over them, strictly.
* The program runs on the device it was traced on (``manifest["device"]``,
  e.g. ``cuda:0``): tensors that the trace creates, such as the anchors,
  are constants on that device.  The JAX artifact is lowered for a list of
  platforms.
* The batch is fixed, as in JAX.

The exported function is ``(left [B, H, W, 3], right, *calib_batch,
content_wh [B, 2]) -> flat tuple``; :class:`ExportedPipeline` takes a
``StereoCalib`` of [B] tensors and returns the outputs as named tuples
with the fields of ``inference.Detections3D`` and ``Detections``.
"""

from __future__ import annotations

import collections
import io
import json
import zipfile

import torch

from stereo_rcnn_tpu_torch.geometry.calib import StereoCalib
from stereo_rcnn_tpu_torch.inference import Detections3D, make_full_pipeline
from stereo_rcnn_tpu_torch.models.detector import Detections

FORMAT = "stereo_rcnn_tpu_torch.manifest"
_MANIFEST = "manifest.json"


class _Served(torch.nn.Module):
    """The pipeline over plain tensors: the traced module.  Its weights are
    the model's, under ``model.``."""

    def __init__(self, cfg, model):
        super().__init__()
        self.model = model
        self.pipeline = make_full_pipeline(cfg)

    def forward(self, left, right, f, cu, cv, baseline, tx2, p2, p3,
                content_wh):
        out = self.pipeline(self.model, left, right,
                            StereoCalib(f, cu, cv, baseline, tx2, p2, p3),
                            content_wh)
        return (*out.det, *out[1:])


class ExportedPipeline:
    """A loaded artifact: ``pipe(left, right, calib_batch, content_wh=None)``
    on the artifact's device returns ``Detections3D``-shaped named
    tuples; inputs on another device raise ``ValueError``."""

    def __init__(self, module: torch.nn.Module, manifest: dict):
        self.module = module
        self.manifest = manifest
        out = manifest["outputs"]
        self._det = collections.namedtuple("Detections", out["det"])
        self._out = collections.namedtuple("Detections3D",
                                           ["det", *out["rest"]])

    def load_state_dict(self, state_dict) -> None:
        """Load a ``state_dict`` of the exported config (the port's names,
        as a params export holds them) over the artifact's weights;
        raises on a missing, unknown or misshapen tensor."""
        self.module.load_state_dict(
            {f"model.{k}": v for k, v in state_dict.items()}, strict=True)

    @torch.no_grad()
    def __call__(self, images_left, images_right, calib_batch,
                 content_wh=None):
        if str(images_left.device) != self.manifest["device"]:
            raise ValueError(f"the artifact runs on {self.manifest['device']}"
                             f", not {images_left.device}")
        if content_wh is None:
            h, w = self.manifest["image_hw"]
            content_wh = torch.tensor(
                [float(w), float(h)], device=images_left.device).expand(
                    images_left.shape[0], 2)
        flat = self.module(images_left, images_right, *calib_batch,
                           content_wh)
        n = len(self._det._fields)
        return self._out(self._det(*flat[:n]), *flat[n:])


def trace_pipeline(cfg, model, batch: int):
    """Trace ``make_full_pipeline(cfg)`` with ``model`` (its weights and
    device) at a fixed ``batch`` of ``cfg.data`` images; returns the
    ``torch.export`` program and its manifest.  Traced under
    ``torch.no_grad()``: the pipeline's own ``no_grad`` decorator would
    otherwise leave a grad-mode node that ``torch.export.load`` refuses."""
    h, w = cfg.data.image_h, cfg.data.image_w
    dev = next(model.parameters()).device
    images = torch.zeros((batch, h, w, 3), device=dev)
    calib = [torch.zeros((batch,) + shape, device=dev)
             for shape in [()] * 5 + [(3, 4)] * 2]
    content_wh = torch.tensor([float(w), float(h)],
                              device=dev).expand(batch, 2).contiguous()
    with torch.no_grad():
        program = torch.export.export(
            _Served(cfg, model.eval()),
            (images, images.clone(), *calib, content_wh), strict=False)
    manifest = {
        "format": FORMAT, "batch": batch, "image_hw": [h, w],
        "device": str(dev),
        "num_params": sum(t.numel() for t in model.state_dict().values()),
        "outputs": {"det": list(Detections._fields),
                    "rest": list(Detections3D._fields[1:])},
    }
    return program, manifest


def serialize(program, manifest: dict) -> bytes:
    """The artifact's bytes: ``torch.export.save`` with the manifest as an
    extra file, without the trace's example inputs (zero images, 94 MB at
    batch 8 of 1280x384)."""
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files={_MANIFEST: json.dumps(manifest)})
    return buf.getvalue()


def export_pipeline(cfg, model, batch: int) -> bytes:
    """:func:`trace_pipeline`, then :func:`serialize`."""
    return serialize(*trace_pipeline(cfg, model, batch))


def _manifest(blob: bytes) -> dict:
    """The manifest of an artifact; ``ValueError`` for anything that is
    not one."""
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            names = [n for n in zf.namelist()
                     if n.endswith(f"/extra/{_MANIFEST}")]
            manifest = json.loads(zf.read(names[0])) if names else {}
    except (zipfile.BadZipFile, ValueError):
        manifest = {}
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        raise ValueError("not a stereo_rcnn_tpu_torch export artifact")
    return manifest


def load_pipeline(blob: bytes) -> ExportedPipeline:
    """Deserialize a blob from :func:`export_pipeline`."""
    manifest = _manifest(blob)
    program = torch.export.load(io.BytesIO(blob))
    return ExportedPipeline(program.module(), manifest)
