"""Training on one card (port of ``repro.training``): the optimizers
(AdamW, Adafactor, SGD-momentum) with the cosine schedule and global-norm
clipping, the train step with microbatching, the checkpoint manager,
error-feedback gradient compression, and ``elastic`` (the fleet planner,
heartbeats and straggler monitor, which ``repro_torch.serving.elastic``
also drives).  ``repro_torch.sharding.partition`` gives the train
state's shardings on a mesh, ``CheckpointManager.restore(shardings=...)``
re-shards a checkpoint onto one, and ``repro_torch.launch.dryrun`` traces
the sharded train step; as in the reference, no data-parallel step runs
on real ranks."""

from .checkpoint import CheckpointManager
from .optimizer import (OPTIMIZERS, Optimizer, adafactor, adamw,
                        clip_by_global_norm, cosine_schedule, global_norm,
                        make_optimizer, sgdm)
from .train_loop import (TrainState, abstract_train_state, cross_entropy,
                         init_train_state, loss_and_grads, make_loss_fn,
                         make_train_step)

__all__ = ["CheckpointManager", "OPTIMIZERS", "Optimizer", "adafactor",
           "adamw", "clip_by_global_norm", "cosine_schedule", "global_norm",
           "make_optimizer", "sgdm", "TrainState", "abstract_train_state",
           "cross_entropy", "init_train_state", "loss_and_grads",
           "make_loss_fn", "make_train_step"]
