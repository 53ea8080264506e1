"""MiniLM-class sentence encoder as a torch ``nn.Module``.

Counterpart of ``rag_faiss_embedding_tpu/models/minilm.py`` (the Flax
encoder), the same network: a BERT post-LN encoder at MiniLM-L6 scale
(6 layers, hidden 384, 12 heads, FFN 1536, vocab 30522, 512 positions).

- word + position + token-type embeddings, then LayerNorm (eps 1e-12, f32);
- the attention mask is added to the float32 logits as -1e9, softmax in f32;
- exact (erf) GELU;
- CLS or mean pooling; only the (B, hidden) pooled output leaves.

Module names follow the Flax parameter tree (``models/convert.py`` moves
weights across). There is no dropout: the JAX trainer and its embedder both
run the Flax module with ``deterministic=True``. The module carries
gradients, so ``parallel/train.py`` trains it directly; the embedding
pipeline runs it under ``torch.inference_mode()``.

``MiniLMConfig(dtype="bfloat16")`` is the Flax model's bf16 compute mode,
step by step: parameters stay float32 and are cast at use; the three
embedding lookups are cast to bf16 and summed in bf16; every LayerNorm runs
in float32 and is cast back; each Dense is a bf16 product (float32
accumulation) plus its bf16 bias; the attention logits are float32, the
probabilities cast to bf16; the pooled output comes back float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1  # kept for config parity; never applied
    dtype: str = "float32"  # compute dtype: "float32" or "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _dense(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``m`` in the compute dtype of ``x``: in bf16 the product (rounded to
    bf16) and then the bias, as Flax's ``Dense(dtype=bfloat16)`` adds them."""
    if x.dtype == torch.float32:
        return m(x)
    return F.linear(x, m.weight.to(x.dtype)) + m.bias.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU. In bf16 it is JAX's own form, op by op, each op
    rounded to bf16 (``0.5 * x * erfc(-x * sqrt(1/2))``), which gives the
    Flax encoder's bits where one fused GELU rounds once."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return 0.5 * x * torch.erfc(-x * x.new_tensor(0.5 ** 0.5))


class Embeddings(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        self.compute_dtype = cfg.compute_dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(cd)
             + self.position_embeddings(pos)[None].to(cd)
             + self.token_type_embeddings(token_type_ids).to(cd))
        return self.layer_norm(x.float()).to(cd)


class SelfAttention(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        split = lambda y: y.view(b, t, self.num_heads, self.head_dim)
        q, k, v = (split(_dense(m, x)) for m in (self.query, self.key, self.value))
        # float32 logits and softmax in either compute dtype
        logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * self.head_dim ** -0.5
        probs = torch.softmax(logits + attn_bias, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhts,bshd->bthd", probs, v)
        return _dense(self.output, ctx.reshape(b, t, h))


class Layer(nn.Module):
    def __init__(self, cfg: MiniLMConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = SelfAttention(cfg)
        self.attention_norm = nn.LayerNorm(h, eps=eps)
        self.intermediate = nn.Linear(h, cfg.intermediate_size)
        self.ffn_output = nn.Linear(cfg.intermediate_size, h)
        self.ffn_norm = nn.LayerNorm(h, eps=eps)

    def forward(self, x: torch.Tensor, attn_bias: torch.Tensor) -> torch.Tensor:
        cd = x.dtype  # LayerNorms in float32, cast back
        x = self.attention_norm((x + self.attention(x, attn_bias)).float()).to(cd)
        hdn = _gelu(_dense(self.intermediate, x))
        return self.ffn_norm((x + _dense(self.ffn_output, hdn)).float()).to(cd)


class MiniLMEncoder(nn.Module):
    """BERT-style encoder producing pooled sentence embeddings."""

    def __init__(self, cfg: MiniLMConfig = MiniLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        *,
        pooling: str = "cls",
    ) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        # additive mask: 0 for real tokens, large-negative for padding
        attn_bias = torch.where(
            attention_mask[:, None, None, :] > 0, 0.0, -1e9
        ).to(torch.float32)
        for layer in self.layers:
            x = layer(x, attn_bias)
        x = x.float()
        if pooling == "cls":
            # reference uses CLS-token pooling (vectorization.py:44)
            return x[:, 0]
        if pooling == "mean":
            mask = attention_mask[..., None].to(torch.float32)
            return (x * mask).sum(1) / mask.sum(1).clamp_min(1e-9)
        raise ValueError(f"unknown pooling {pooling!r}")

    def init_params(self, rng: int | torch.Generator, max_len: int = 8) -> dict:
        """A fresh Flax-layout parameter tree (numpy) for this config, drawn
        from ``rng`` (a seed or a ``torch.Generator``) with the distributions
        of Flax's default initializers, as ``convert.deterministic_params``
        draws them. It cannot reproduce ``jax.random``'s bits: to compare
        the two packages, give both one parameter tree. ``max_len`` is the
        Flax version's dummy input length; the tree does not depend on it."""
        from .convert import deterministic_params

        return deterministic_params(self.cfg, rng)
