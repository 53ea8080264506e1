"""Contrastive training for the sentence encoder, on one card or a mesh.

Counterpart of ``rag_faiss_embedding_tpu/parallel/train.py``, the same
training: in-batch-negative InfoNCE (row i of the queries matches row i of
the documents, every other document of the batch is a negative) over the
encoder's pooled embeddings, optimised by AdamW with optax's defaults
(b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight decay 1e-4 on
every parameter, LayerNorms and biases included), without dropout (the JAX
step runs the Flax module with ``deterministic=True``).

In torch idiom the state is mutable. With no mesh, or a mesh of one
position, ``TrainState.params`` is the ``MiniLMEncoder`` (its weights are the
parameters), ``opt_state`` its ``torch.optim.AdamW`` (the moments and each
parameter's step count), and ``step`` the number of steps taken.
``state_from_flax`` turns the JAX trainer's state (the Flax params tree,
optax's ``ScaleByAdamState`` and the step, as numpy trees) into this one, so
a JAX run continues here.

On a mesh of more positions the step runs over the mesh, as JAX's one
jitted step does. One process owns every device of a ``core/mesh.Mesh``
(JAX's one controller; devices may repeat, so a mesh fits on one card or
the CPU), and no ``torch.distributed`` group is involved:

- **data parallel** over ``data_axis``: the (queries, documents) batch is
  split on dim 0, each data row runs its part on its own devices, and the
  pooled embeddings of every row are gathered on the mesh's first device,
  so the InfoNCE negatives span the global batch, as in JAX;
- **tensor parallel** over ``"model"``, Megatron's layout in one process
  (``param_sharding_rules``): model position m holds a slice of the heads
  (q / k / v rows, attention-output columns), of the FFN (``intermediate``
  rows, ``ffn_output`` columns) and of the vocabulary (a vocab-parallel
  lookup: an id outside the slice gives 0). The positions' partial
  (B, T, H) outputs are summed on the data row's lead device, the
  all-reduce, and the bias, residual and LayerNorm follow there. A group
  that ``shard_params`` leaves whole, as the "model" size does not divide
  it, runs whole on the lead device; a mesh without "model" keeps every
  parameter whole;
- **one owner per slice**: each is one parameter on its data row 0 device.
  The other rows use a differentiable copy made in each forward, so
  autograd sums every row's gradient into the owner (the data-parallel
  all-reduce), and one AdamW steps each slice once. AdamW is elementwise,
  so a slice's update is the whole leaf's.

``TrainState.params`` is then a ``MeshEncoder`` and ``opt_state`` its
``MeshAdamW``. Their ``state_dict`` / ``load_state_dict`` gather and
scatter the one-card layout (a ``MiniLMEncoder`` state dict, AdamW's state
in its parameter order), so checkpoints and exported parameters cross
meshes and one card both ways.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..core.logging import get_logger
from ..core.mesh import Mesh, Placement
from ..models.convert import deterministic_params, load_flax_params
from ..models.minilm import MiniLMConfig, MiniLMEncoder, _gelu

logger = get_logger(__name__)

BATCH_KEYS = ("q_ids", "q_mask", "d_ids", "d_mask")
# optax.adamw's settings: weight decay 1e-4 on every parameter (torch's
# default is 1e-2)
_ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


@dataclasses.dataclass
class TrainState:
    params: nn.Module  # a MiniLMEncoder, or a MeshEncoder on a mesh
    opt_state: torch.optim.Optimizer
    step: int


def adamw(model: MiniLMEncoder, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` in torch: the same update."""
    return torch.optim.AdamW(model.parameters(), lr=learning_rate, **_ADAMW)


def param_sharding_rules(path_str: str) -> Tuple[Optional[str], ...]:
    """Megatron-style TP layout for the MiniLM param tree.

    QKV DenseGeneral kernels (hidden, heads, head_dim): shard heads.
    Attention output (heads, head_dim, hidden): shard heads (row-parallel).
    FFN intermediate (hidden, ffn): shard ffn columns;
    FFN output (ffn, hidden): shard ffn rows.
    Embeddings: shard vocab rows. LayerNorms/biases: replicated.
    """
    if "word_embeddings" in path_str:
        return ("model", None)
    if "attention" in path_str and "kernel" in path_str:
        if "output" in path_str:
            return ("model", None, None)   # (heads, head_dim, hidden)
        return (None, "model", None)       # (hidden, heads, head_dim)
    if "attention" in path_str and "bias" in path_str and "norm" not in path_str:
        if "output" in path_str:
            return (None,)
        return ("model", None)             # (heads, head_dim)
    if "intermediate" in path_str and "kernel" in path_str:
        return (None, "model")
    if "intermediate" in path_str and "bias" in path_str:
        return ("model",)
    if "ffn_output" in path_str and "kernel" in path_str:
        return ("model", None)
    return None  # replicate


def _leaf_spec(path_str: str, shape, mesh: Mesh) -> tuple:
    """The spec JAX's ``shard_params`` gives a leaf: "model" on a dimension
    its rule names and the "model" size divides, else None; () for a leaf
    with no rule, or on a mesh without "model"."""
    rules = param_sharding_rules(path_str)
    if rules is None or "model" not in mesh.shape:
        return ()
    n = mesh.shape["model"]
    return tuple("model" if rule == "model" and dim % n == 0 else None
                 for dim, rule in zip(shape, rules))


@dataclasses.dataclass
class ShardedParam:
    """A leaf placed on a mesh (JAX's ``jax.Array`` under a
    ``NamedSharding``): its ``placement`` (``.spec`` is JAX's
    ``PartitionSpec`` as a tuple), ``parts``, a numpy object array of the
    mesh's shape holding each position's part on that position's device,
    and the whole leaf's ``shape``."""
    placement: Placement
    parts: np.ndarray
    shape: tuple

    @property
    def spec(self) -> tuple:
        return self.placement.spec


def shard_params(params, mesh: Mesh):
    """Place a Flax-layout parameter tree (numpy leaves) on ``mesh`` by
    ``param_sharding_rules``: the same tree, each leaf a ``ShardedParam``.
    A dimension splits over "model" only where its size divides; a leaf
    with no rule, or a mesh without "model", is copied to every position."""

    def place(tree, path: str):
        if isinstance(tree, dict):
            return {k: place(v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
        leaf = torch.tensor(np.asarray(tree))
        placement = Placement(mesh, _leaf_spec(path, leaf.shape, mesh))
        parts = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(parts.shape):
            parts[pos] = placement.part(leaf, pos)
        return ShardedParam(placement, parts, tuple(leaf.shape))

    return place(params, "")


# The groups "model" splits, each decided by one Flax leaf's spec (every
# leaf of a group splits on the same size), and the MiniLMEncoder
# parameters of each with the torch dimension their split falls on (nn.Linear
# weights are (out, in): a head or FFN slice is rows of q / k / v and
# ``intermediate``, columns of the attention output and ``ffn_output``).
def _group_leaves(cfg: MiniLMConfig) -> dict:
    h = cfg.hidden_size
    return {"vocab": ("embeddings/word_embeddings/embedding", (cfg.vocab_size, h)),
            "heads": ("layer_0/attention/query/kernel",
                      (h, cfg.num_heads, h // cfg.num_heads)),
            "ffn": ("layer_0/intermediate/kernel", (h, cfg.intermediate_size))}


_SPLIT = {
    "word_embeddings.weight": ("vocab", 0),
    **{f"attention.{n}.{w}": ("heads", 0)
       for n in ("query", "key", "value") for w in ("weight", "bias")},
    "attention.output.weight": ("heads", 1),
    "intermediate.weight": ("ffn", 0),
    "intermediate.bias": ("ffn", 0),
    "ffn_output.weight": ("ffn", 1),
}


def _grid(mesh: Mesh, data_axis: str) -> np.ndarray:
    """The (data row, model position) grid of devices: rows along
    ``data_axis``, positions along "model" (one without it), every other
    axis at its position 0 (JAX keeps copies there)."""
    names = mesh.axis_names
    grid = np.empty((mesh.shape[data_axis], mesh.shape.get("model", 1)), dtype=object)
    for d, m in np.ndindex(grid.shape):
        pos = [0] * len(names)
        pos[names.index(data_axis)] = d
        if "model" in names:
            pos[names.index("model")] = m
        grid[d, m] = torch.device(mesh.devices[tuple(pos)])
    return grid


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    """``minilm._dense`` on a weight slice: one product with its bias in
    float32; in bf16 the product, then the bias."""
    if x.dtype == torch.float32:
        return F.linear(x, w, b)
    y = F.linear(x, w.to(x.dtype))
    return y if b is None else y + b.to(x.dtype)


class MeshEncoder(nn.Module):
    """``MiniLMEncoder`` over a mesh (see the module docstring): the same
    forward, to the summation order of the partial products. ``parts[name]``
    holds the slices of the one-card parameter ``name`` ("." written "/"),
    slice m on the data row 0 device of model position m. ``state_dict`` and
    ``load_state_dict`` are the one-card ``MiniLMEncoder``'s: the slices
    gathered on the mesh's first device, and a one-card state dict split back
    onto them."""

    def __init__(self, cfg: MiniLMConfig, state_dict: dict, mesh: Mesh, data_axis: str = "data"):
        super().__init__()
        self.cfg, self.data_axis = cfg, data_axis
        self.grid = _grid(mesh, data_axis)
        n_model = self.grid.shape[1]
        split = {g: n_model if "model" in _leaf_spec(path, shape, mesh) else 1
                 for g, (path, shape) in _group_leaves(cfg).items()}
        with torch.device("meta"):  # MiniLMEncoder's parameter order, AdamW's
            self.names = [name for name, _ in MiniLMEncoder(cfg).named_parameters()]
        self.layout = {}  # name -> (slices, the dim they split)
        self.parts = nn.ModuleDict()
        for name in self.names:
            full = state_dict[name]
            group, dim = next((v for k, v in _SPLIT.items() if name.endswith(k)), (None, 0))
            n = split[group] if group else 1
            self.layout[name] = (n, dim)
            self.parts[name.replace(".", "/")] = nn.ParameterList(
                nn.Parameter(part.detach().to(self.grid[0, m]).clone())
                for m, part in enumerate(full.chunk(n, dim)))

    def slices(self, name: str) -> list:
        return list(self.parts[name.replace(".", "/")])

    def gather(self, name: str, slices) -> torch.Tensor:
        """One parameter's (or moment's) slices as the whole tensor, on the
        mesh's first device."""
        first = self.grid[0, 0]
        return torch.cat([s.to(first) for s in slices], self.layout[name][1])

    def scatter(self, name: str, full: torch.Tensor) -> tuple:
        n, dim = self.layout[name]
        return full.chunk(n, dim)

    def state_dict(self, *args, **kwargs) -> OrderedDict:
        return OrderedDict((name, self.gather(name, [p.detach() for p in self.slices(name)]))
                           for name in self.names)

    def load_state_dict(self, state_dict: dict) -> None:
        if set(state_dict) != set(self.names):
            raise KeyError(f"not a {self.cfg} MiniLMEncoder state dict: "
                           f"{sorted(set(state_dict) ^ set(self.names))}")
        with torch.no_grad():
            for name in self.names:
                for p, part in zip(self.slices(name), self.scatter(name, state_dict[name])):
                    p.copy_(part)

    def _row(self, d: int) -> dict:
        """Every slice as data row ``d`` uses it: the owner on row 0, a
        differentiable copy on the row's own device elsewhere (``.to`` of a
        device the owner is on returns the owner itself)."""
        return {name: [p if d == 0 else p.to(self.grid[d, m])
                       for m, p in enumerate(self.slices(name))] for name in self.names}

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None, *,
                pooling: str = "cls") -> torch.Tensor:
        """The pooled (B, hidden) embeddings of the global batch, on the
        mesh's first device. B must split evenly over the data axis."""
        rows = self.grid.shape[0]
        if input_ids.shape[0] % rows:
            raise ValueError(f"a batch of {input_ids.shape[0]} does not split over "
                             f"{self.data_axis}={rows}")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        parts = zip(*(t.chunk(rows) for t in (input_ids, attention_mask, token_type_ids)))
        pooled = [self._row_forward(d, *(t.to(self.grid[d, 0]) for t in part), pooling)
                  for d, part in enumerate(parts)]
        return torch.cat([p.to(self.grid[0, 0]) for p in pooled])

    def _layer_norm(self, P: dict, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (self.cfg.hidden_size,), P[f"{name}.weight"][0],
                            P[f"{name}.bias"][0], self.cfg.layer_norm_eps).to(x.dtype)

    def _row_forward(self, d: int, ids, mask, types, pooling: str) -> torch.Tensor:
        P, cd = self._row(d), self.cfg.compute_dtype
        x = self._embed(P, ids, types).to(cd)
        x = self._layer_norm(P, "embeddings.layer_norm", x)
        attn_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
        for i in range(self.cfg.num_layers):
            L = f"layers.{i}"
            x = self._layer_norm(P, f"{L}.attention_norm", x + self._attention(P, L, x, attn_bias))
            x = self._layer_norm(P, f"{L}.ffn_norm", x + self._ffn(P, L, x))
        x = x.float()
        if pooling == "cls":
            return x[:, 0]
        if pooling == "mean":
            m = mask[..., None].to(torch.float32)
            return (x * m).sum(1) / m.sum(1).clamp_min(1e-9)
        raise ValueError(f"unknown pooling {pooling!r}")

    def _embed(self, P: dict, ids, types) -> torch.Tensor:
        """Word + position + token-type embeddings in the compute dtype; the
        word lookup vocab-parallel, each slice giving 0 outside its rows."""
        cd, lead = self.cfg.compute_dtype, ids.device
        tables = P["embeddings.word_embeddings.weight"]
        rows = tables[0].shape[0]
        word = None
        for m, table in enumerate(tables):
            local = ids.to(table.device) - m * rows
            inside = ((local >= 0) & (local < rows))[..., None]
            part = torch.where(inside, F.embedding(local.clamp(0, rows - 1), table), 0.0)
            word = part.to(lead) if word is None else word + part.to(lead)
        pos = torch.arange(ids.shape[-1], device=lead)
        return (word.to(cd) + P["embeddings.position_embeddings.weight"][0][pos][None].to(cd)
                + F.embedding(types, P["embeddings.token_type_embeddings.weight"][0]).to(cd))

    def _attention(self, P: dict, L: str, x: torch.Tensor, attn_bias) -> torch.Tensor:
        """Self-attention, each model position over its heads; the output
        bias joins position 0's partial product."""
        b, t, h = x.shape
        hd = h // self.cfg.num_heads
        q_w, k_w, v_w, o_w = (P[f"{L}.attention.{n}.weight"]
                              for n in ("query", "key", "value", "output"))
        q_b, k_b, v_b = (P[f"{L}.attention.{n}.bias"] for n in ("query", "key", "value"))
        o_b = P[f"{L}.attention.output.bias"][0]
        out = None
        for m in range(len(q_w)):
            xm, bias = x.to(q_w[m].device), attn_bias.to(q_w[m].device)
            q, k, v = (_linear(xm, w[m], bb[m]).view(b, t, -1, hd)
                       for w, bb in ((q_w, q_b), (k_w, k_b), (v_w, v_b)))
            logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * hd ** -0.5
            probs = torch.softmax(logits + bias, dim=-1).to(x.dtype)
            ctx = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, -1)
            part = _linear(ctx, o_w[m], o_b if m == 0 else None).to(x.device)
            out = part if out is None else out + part
        return out

    def _ffn(self, P: dict, L: str, x: torch.Tensor) -> torch.Tensor:
        """The FFN, each model position over its columns; the output bias
        joins position 0's partial product."""
        i_w, i_b, f_w = (P[f"{L}.{n}"] for n in ("intermediate.weight", "intermediate.bias",
                                                 "ffn_output.weight"))
        f_b = P[f"{L}.ffn_output.bias"][0]
        out = None
        for m in range(len(i_w)):
            hdn = _gelu(_linear(x.to(i_w[m].device), i_w[m], i_b[m]))
            part = _linear(hdn, f_w[m], f_b if m == 0 else None).to(x.device)
            out = part if out is None else out + part
        return out


class MeshAdamW(torch.optim.AdamW):
    """``adamw`` over a ``MeshEncoder``'s slices, each stepped once. Its
    ``state_dict`` / ``load_state_dict`` are the one-card AdamW's: each
    parameter's moments gathered in ``MiniLMEncoder`` order, and a one-card
    state split back onto the slices (on their devices)."""

    def __init__(self, encoder: MeshEncoder, learning_rate: float):
        super().__init__(encoder.parameters(), lr=learning_rate, **_ADAMW)
        self.encoder = encoder

    def _slots(self):
        """(one-card index, name, the slices' first optimizer index)."""
        j = 0
        for i, name in enumerate(self.encoder.names):
            yield i, name, j
            j += self.encoder.layout[name][0]

    def state_dict(self) -> dict:
        sd, enc = super().state_dict(), self.encoder
        state = {}
        for i, name, j in self._slots():
            per = [sd["state"].get(j + m) for m in range(enc.layout[name][0])]
            if per[0] is not None:
                state[i] = {k: v if k == "step" else enc.gather(name, [s[k] for s in per])
                            for k, v in per[0].items()}
        groups = [{**g, "params": list(range(len(enc.names)))} for g in sd["param_groups"]]
        return {"state": state, "param_groups": groups}

    def load_state_dict(self, state_dict: dict) -> None:
        enc, state = self.encoder, {}
        for i, name, j in self._slots():
            per = state_dict["state"].get(i)
            if per is None:
                continue
            split = {k: enc.scatter(name, v) for k, v in per.items() if k != "step"}
            for m in range(enc.layout[name][0]):
                # clones: AdamW updates the step count and moments in place
                state[j + m] = {k: v.clone() if k == "step" else split[k][m].clone()
                                for k, v in per.items()}
        n = sum(enc.layout[name][0] for name in enc.names)
        groups = [{**g, "params": list(range(n))} for g in state_dict["param_groups"]]
        super().load_state_dict({"state": state, "param_groups": groups})


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


def train_step_fn(model: nn.Module, optimizer: torch.optim.Optimizer,
                  pooling: str = "mean"):
    """The step ``batch -> metrics``: one InfoNCE gradient step that updates
    ``model`` (a ``MiniLMEncoder`` or a ``MeshEncoder``) and ``optimizer``
    in place. ``batch`` holds the four (B, T) token arrays, on any device."""
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


def _encoder(cfg: MiniLMConfig, params: Optional[Any], device) -> MiniLMEncoder:
    model = MiniLMEncoder(cfg)
    model.load_state_dict(load_flax_params(params if params is not None
                                           else deterministic_params(cfg)))
    return model.to(device).train()


def make_train_step(
    cfg: MiniLMConfig,
    mesh: Optional[Mesh] = None,
    learning_rate: float = 2e-5,
    data_axis: str = "data",
    params: Optional[Any] = None,
    pooling: str = "mean",
    device: Optional[torch.device | str] = None,
):
    """(run_step, initial TrainState). ``params``: a Flax-layout tree
    (default ``deterministic_params(cfg)``). ``run_step(state, batch)``
    returns (the state one step on, {"loss", "accuracy"}); it trains
    whatever state it is given, where that state lives.

    A mesh of more than one position trains over it (the module docstring):
    the batch splits over ``data_axis``, the parameters over "model" where
    present. A mesh must have ``data_axis``. With no mesh, or one of one
    position, the state lives on ``device`` (default: the mesh's device,
    else the card)."""
    if mesh is not None and data_axis not in mesh.shape:
        raise ValueError(f"the mesh {dict(mesh.shape)} has no {data_axis!r} axis")
    if mesh is not None and mesh.devices.size > 1:
        sd = load_flax_params(params if params is not None else deterministic_params(cfg))
        model = MeshEncoder(cfg, sd, mesh, data_axis).train()
        opt = MeshAdamW(model, learning_rate)
    else:
        if device is None and isinstance(mesh, Mesh):
            device = mesh.devices.flat[0]
        model = _encoder(cfg, params, torch.device(device) if device is not None
                         else default_device())
        opt = adamw(model, learning_rate)
    state = TrainState(params=model, opt_state=opt, step=0)

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
