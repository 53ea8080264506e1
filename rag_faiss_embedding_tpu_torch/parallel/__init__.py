"""Sharded search over a device mesh (``sharded``: ``ShardedFlatIndex``,
``sharded_exact_search``; ``sharded_ivf``: ``ShardedIVFIndex``), contrastive
training of the encoder on one card or over a mesh, data and tensor parallel
(``train``: ``make_train_step``, ``param_sharding_rules``, ``shard_params``)
and its checkpoints (``checkpoint``)."""

from .sharded import ShardedFlatIndex, sharded_exact_search
from .train import TrainState, make_train_step, train_step_fn
