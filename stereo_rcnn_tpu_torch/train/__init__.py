"""Training (torch): targets, losses, optimizer and the train step."""

from stereo_rcnn_tpu_torch.train.step import (Batch, TrainState,
                                              compute_losses,
                                              init_train_state,
                                              make_optimizer,
                                              make_train_step, param_label,
                                              step_generator)
