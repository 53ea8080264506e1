"""Contrastive training for the sentence encoder, on one card.

Counterpart of ``rag_faiss_embedding_tpu/parallel/train.py``, the same
training: in-batch-negative InfoNCE (row i of the queries matches row i of
the documents, every other document of the batch is a negative) over the
encoder's pooled embeddings, optimised by AdamW with optax's defaults
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight decay 1e-4 on
every parameter, LayerNorms and biases included), without dropout (the JAX
step runs the Flax module with ``deterministic=True``).

In torch idiom the state is mutable: ``TrainState.params`` is the
``MiniLMEncoder`` (its weights are the parameters), ``opt_state`` its
``torch.optim.AdamW`` (the moments and each parameter's step count), and
``step`` the number of steps taken. ``state_from_flax`` turns the JAX
trainer's state (the Flax params tree, optax's ``ScaleByAdamState`` and the
step, as numpy trees) into this one, so a JAX run continues here.

One card, no mesh: ``make_train_step`` accepts ``mesh=None`` or a mesh of
one device. Data parallelism and the JAX trainer's tensor-parallel layout
(``param_sharding_rules``, ``shard_params``) belong to the multi-GPU port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device
from ..core.logging import get_logger
from ..models.convert import deterministic_params, load_flax_params
from ..models.minilm import MiniLMConfig, MiniLMEncoder

logger = get_logger(__name__)

BATCH_KEYS = ("q_ids", "q_mask", "d_ids", "d_mask")


@dataclasses.dataclass
class TrainState:
    params: MiniLMEncoder
    opt_state: torch.optim.Optimizer
    step: int


def adamw(model: MiniLMEncoder, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` in torch: the same update, weight
    decay 1e-4 on every parameter (torch's default is 1e-2)."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def info_nce_loss(q_emb: torch.Tensor, d_emb: torch.Tensor, temperature: float = 0.05):
    """In-batch-negatives InfoNCE: (mean loss, accuracy). Rows are divided
    by max(norm, 1e-9), as JAX does; accuracy takes the first index on
    ties."""
    q = q_emb / torch.linalg.vector_norm(q_emb, dim=-1, keepdim=True).clamp_min(1e-9)
    d = d_emb / torch.linalg.vector_norm(d_emb, dim=-1, keepdim=True).clamp_min(1e-9)
    logits = (q @ d.T) / temperature
    labels = torch.arange(q.shape[0], device=logits.device)
    loss = F.cross_entropy(logits, labels)
    acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
    return loss, acc


def train_step_fn(model: MiniLMEncoder, optimizer: torch.optim.Optimizer,
                  pooling: str = "mean"):
    """The step ``batch -> metrics``: one InfoNCE gradient step that updates
    ``model`` and ``optimizer`` in place. ``batch`` holds the four (B, T)
    token arrays, on any device."""
    device = next(model.parameters()).device

    def step(batch) -> dict:
        b = {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS}
        q_emb = model(b["q_ids"], b["q_mask"], pooling=pooling)
        d_emb = model(b["d_ids"], b["d_mask"], pooling=pooling)
        loss, acc = info_nce_loss(q_emb, d_emb)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "accuracy": acc.detach()}

    return step


def _check_mesh(mesh) -> None:
    """One card: no mesh, or a mesh of one device."""
    if mesh is None:
        return
    size = getattr(mesh, "size", None)
    size = size() if callable(size) else size
    if size is None:
        size = int(np.size(getattr(mesh, "devices", mesh)))
    if int(size) > 1:
        raise NotImplementedError(
            f"a {size}-device mesh: data- and tensor-parallel training is the multi-GPU "
            "slice (ROADMAP Queue 1 item 7); this trainer runs on one card")


def _encoder(cfg: MiniLMConfig, params: Optional[Any], device) -> MiniLMEncoder:
    model = MiniLMEncoder(cfg)
    model.load_state_dict(load_flax_params(params if params is not None
                                           else deterministic_params(cfg)))
    return model.to(device).train()


def make_train_step(
    cfg: MiniLMConfig,
    mesh=None,
    learning_rate: float = 2e-5,
    data_axis: str = "data",
    params: Optional[Any] = None,
    pooling: str = "mean",
    device: Optional[torch.device | str] = None,
):
    """(run_step, initial TrainState). ``params``: a Flax-layout tree
    (default ``deterministic_params(cfg)``). ``run_step(state, batch)``
    returns (the state one step on, {"loss", "accuracy"}); it trains
    whatever state it is given, on that state's device. ``data_axis`` is
    accepted for the JAX API; there is no batch sharding on one card."""
    _check_mesh(mesh)
    device = torch.device(device) if device is not None else default_device()
    model = _encoder(cfg, params, device)
    state = TrainState(params=model, opt_state=adamw(model, learning_rate), step=0)

    def run_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        metrics = train_step_fn(state.params, state.opt_state, pooling)(batch)
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return run_step, state


def state_from_flax(cfg: MiniLMConfig, params, adam, step: int,
                    learning_rate: float = 2e-5,
                    device: Optional[torch.device | str] = None) -> TrainState:
    """The JAX trainer's state as this package's ``TrainState``: ``params``
    the Flax-layout tree, ``adam`` optax's ``ScaleByAdamState`` (anything
    with ``count``, ``mu`` and ``nu``; the moments laid out like the params,
    so they take the same reshapes and transposes), ``step`` the step
    count. ``count`` becomes every parameter's AdamW step."""
    device = torch.device(device) if device is not None else default_device()
    model = _encoder(cfg, params, device)
    opt = adamw(model, learning_rate)
    mu, nu = load_flax_params(adam.mu), load_flax_params(adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(count),
                        "exp_avg": mu[name].to(device).clone(),
                        "exp_avg_sq": nu[name].to(device).clone()}
    return TrainState(params=model, opt_state=opt, step=int(np.asarray(step)))
