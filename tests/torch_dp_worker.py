"""Ranks of ``tests/test_torch_parallel.py``'s spawned runs: gloo on the
CPU, the port only (no JAX is imported here).

``rank_main(inputs_path, out_dir)`` reads the inputs the test wrote
(``torch.save``), forms the mesh, takes one data-parallel training step
and runs the sharded inference pipeline, and writes what it saw to
``<out_dir>/rank<r>.pt`` (the updated parameters as one sha256, rank 0
also the watched ones: a state is 300 MB).  ``report_env`` checks the launcher.
"""

import hashlib
import os

import numpy as np
import torch


def rank_main(inputs_path: str, out_dir: str) -> int:
    from stereo_rcnn_tpu_torch.inference import make_full_pipeline
    from stereo_rcnn_tpu_torch.models.detector import build_model
    from stereo_rcnn_tpu_torch.parallel import (batch_sharding,
                                                data_parallel_inference,
                                                data_parallel_train_step,
                                                make_mesh, replicate,
                                                shard_batch)
    from stereo_rcnn_tpu_torch.train import (Batch, init_train_state,
                                             make_train_step)
    from stereo_rcnn_tpu_torch.train.step import trainable_params
    from stereo_rcnn_tpu_torch.train.targets import ground_truth_to_torch

    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    inp = torch.load(inputs_path, weights_only=False)
    cfg = inp["cfg"]
    out = {}
    with make_mesh(2, device="cpu") as mesh:
        out["mesh"] = (mesh.world_size, mesh.rank, mesh.data_size,
                       mesh.data_index, mesh.model_index, mesh.backend)
        mp2 = make_mesh(2, model_parallel=2, device="cpu")
        out["mesh_mp2"] = (mp2.data_size, mp2.data_index, mp2.model_index)
        x = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
        out["rows"] = (shard_batch(mesh, x),
                       batch_sharding(mesh).rows(2))

        # One data-parallel step from the state the test gives, on this
        # rank's rows, with the global batch's uniforms.
        state = init_train_state(cfg, state_dict=inp["train_sd"],
                                 device="cpu")
        replicate(mesh, [state.model, state.uncert])
        il, ir, gt = shard_batch(mesh, inp["batch"])
        step = data_parallel_train_step(
            make_train_step(cfg, inp["steps_per_epoch"], device="cpu"), mesh)
        metrics = step(state, Batch(torch.from_numpy(il),
                                    torch.from_numpy(ir),
                                    ground_truth_to_torch(gt, "cpu")),
                       uniforms=inp["uniforms"])
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        params = trainable_params(state)
        digest = hashlib.sha256()
        for k in sorted(params):
            digest.update(params[k].detach().numpy().tobytes())
        out["digest"] = digest.hexdigest()
        if mesh.rank == 0:
            out["params"] = {k: params[k].detach().clone()
                             for k in inp["watched"]}

        # The sharded pipeline on the global batch, its output layers
        # scaled as the test scales JAX's.
        model = build_model(cfg).eval()
        model.load_state_dict({k: v * inp["infer_scale"].get(k, 1.0)
                               for k, v in inp["train_sd"].items()
                               if k != "uncert"}, strict=True)
        replicate(mesh, model)
        infer = data_parallel_inference(make_full_pipeline(cfg), mesh)
        il2, ir2, calib_b = inp["infer_inputs"]
        out["det"] = infer(model, il2, ir2, calib_b)
    torch.save(out, os.path.join(out_dir, f"rank{out['mesh'][1]}.pt"))
    return 0


def report_env(out_dir: str, hang_rank: int) -> int:
    """Write this rank's torchrun variables to ``<out_dir>/env<r>``; rank
    ``hang_rank`` then hangs, every other rank exits with its rank as its
    code."""
    import time
    rank = int(os.environ["RANK"])
    keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR")
    with open(os.path.join(out_dir, f"env{rank}"), "w") as f:
        f.write(" ".join(os.environ[k] for k in keys))
    if rank == hang_rank:
        time.sleep(600)
    return rank
