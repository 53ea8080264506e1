"""Contrastive training of the encoder on one card (``train``) and its
checkpoints (``checkpoint``). The JAX package's sharded search and the
trainer's tensor-parallel layout are multi-GPU work, not ported here."""

from .train import TrainState, make_train_step, train_step_fn
