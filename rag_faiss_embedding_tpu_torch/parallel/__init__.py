"""Sharded search over a device mesh (``sharded``: ``ShardedFlatIndex``,
``sharded_exact_search``; ``sharded_ivf``: ``ShardedIVFIndex``), contrastive
training of the encoder on one card (``train``) and its checkpoints
(``checkpoint``). The trainer's multi-device layout (``param_sharding_rules``,
``shard_params``) is not ported yet."""

from .sharded import ShardedFlatIndex, sharded_exact_search
from .train import TrainState, make_train_step, train_step_fn
