"""Multi-rank training and rendering over ``torch.distributed`` (port of
``nerf_texture_tpu/parallel/``): meshes of ranks, parameter and batch
splits, the data- and tensor-parallel NGP step (the curved model's is
``train.curved_trainer.curved_train_step(mesh=)``), band-sharded frames
(``parallel.eval.render_image_sharded``) and the multi-process start-up.
"""

from .distributed import initialize_multihost, make_global_mesh
from .sharding import (data_sharded, make_mesh, param_shardings, replicated,
                       shard_params)
from .train import dp_train_step, shard_curved_state, shard_state

__all__ = ["data_sharded", "make_mesh", "param_shardings", "replicated",
           "shard_params", "dp_train_step", "shard_curved_state",
           "shard_state", "initialize_multihost", "make_global_mesh"]
