"""The mesh: distributed serving and training over ``torch.distributed``
(counterpart of ``topk_rec_tpu/parallel``)."""

from .mesh import Mesh, make_mesh, shard_params, replicate
from .train_step import DistributedBPRTrainer, DistributedVBPRTrainer
from .als import DistributedALS
from .distributed import initialize, is_multiprocess, fetch
from .lookup import sharded_lookup
