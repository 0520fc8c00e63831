"""Export the whole inference pipeline as a ``torch.export`` artifact.

    python -m stereo_rcnn_tpu_torch.tools.export_model --out model.pt2 \
        [--config cfg.json | --tiny] [--ckpt-dir runs/exp0] [--batch 4]
    python -m stereo_rcnn_tpu_torch.tools.export_model --verify model.pt2 \
        [--config cfg.json | --tiny]

Port of the JAX package's ``tools/export_model.py``.  The artifact
(``serving.export_pipeline``) is one file that ``serving.load_pipeline``
loads and calls with no model-building code.  It holds the weights it was
traced with: those of ``<ckpt-dir>/params_export`` when ``--ckpt-dir`` is
given (loaded strictly, so a tree that does not match the config raises),
else a random model from seed 0; ``tools.serve`` loads a params export
over them.  It runs on the device it was traced on: the CUDA card
(``--platform auto``, which raises without one) or the CPU
(``--platform cpu``).  The JAX tool's ``--platforms`` (StableHLO lowering
targets) has no counterpart.

``--verify ARTIFACT`` loads an artifact and runs one rendered batch
through it with its own weights, on the artifact's device; the config
must have the artifact's resolution.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--config", default=None, help="config (.json or YAML)")
    p.add_argument("--ckpt-dir", default=None,
                   help="trace with <ckpt-dir>/params_export's weights "
                        "(loaded strictly: validates the tree)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--verify", default=None, metavar="ARTIFACT",
                   help="load an artifact and run one rendered batch "
                        "through it instead of exporting")
    p.add_argument("--platform", default="auto", choices=["auto", "cpu"],
                   help="auto: the CUDA card (raises without one); cpu")
    return p.parse_args(argv)


def _config(args):
    from stereo_rcnn_tpu_torch.config import (Config, load_config,
                                              tiny_test_config)
    if args.config:
        return load_config(args.config)
    return tiny_test_config() if args.tiny else Config()


def verify(args) -> int:
    import torch

    from stereo_rcnn_tpu_torch.data.synthetic import synthetic_images
    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.inference import broadcast_calib
    from stereo_rcnn_tpu_torch.serving import load_pipeline

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    t0 = time.perf_counter()
    with open(args.verify, "rb") as f:
        pipe = load_pipeline(f.read())
    m = pipe.manifest
    print(f"artifact: batch={m['batch']} image_hw={m['image_hw']} "
          f"device={m['device']} params={m['num_params']:,}, loaded in "
          f"{time.perf_counter() - t0:.1f}s")
    cfg = _config(args)
    if [cfg.data.image_h, cfg.data.image_w] != m["image_hw"]:
        raise SystemExit(
            f"config resolution {[cfg.data.image_h, cfg.data.image_w]} != "
            f"artifact {m['image_hw']}: pass the config the artifact was "
            "exported with (--config/--tiny)")
    b = m["batch"]
    il, ir, calib = synthetic_images(cfg, b, seed=3)
    out = pipe(torch.from_numpy(il).to(dev), torch.from_numpy(ir).to(dev),
               broadcast_calib(calib, b, dev))
    print(f"verify OK: ran batch {b}, {int(out.det.valid.sum())} detections")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.verify:
        return verify(args)
    import os

    import torch

    from stereo_rcnn_tpu_torch.device import resolve_device
    from stereo_rcnn_tpu_torch.models.detector import build_model, init_params
    from stereo_rcnn_tpu_torch.serving import serialize, trace_pipeline
    from stereo_rcnn_tpu_torch.train.checkpoint import restore_params

    dev = resolve_device(None if args.platform == "auto" else "cpu")
    cfg = _config(args)
    if args.ckpt_dir:
        path = os.path.join(args.ckpt_dir, "params_export")
        model = restore_params(path, build_model(cfg).to(dev).eval())
        print(f"parameter tree validated against {path}")
    else:
        model = init_params(cfg, torch.Generator().manual_seed(0), dev)
        print("WARNING: random weights (no --ckpt-dir)")
    t0 = time.perf_counter()
    program, manifest = trace_pipeline(cfg, model, args.batch)
    t1 = time.perf_counter()
    blob = serialize(program, manifest)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {len(blob) / 1e6:.1f} MB -> {args.out} (batch="
          f"{args.batch}, device={dev}): traced in {t1 - t0:.1f}s, saved in "
          f"{time.perf_counter() - t1:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
