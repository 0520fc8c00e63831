"""Data parallelism over ``torch.distributed`` (the port of
``stereo_rcnn_tpu.parallel``)."""

from stereo_rcnn_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                                 batch_sharding,
                                                 data_parallel_inference,
                                                 data_parallel_train_step,
                                                 make_mesh, replicate,
                                                 shard_batch)
