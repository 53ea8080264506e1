"""Parameter conversion: Flax param trees and npz files <-> torch state dicts.

Counterpart of ``rag_faiss_embedding_tpu/models/convert.py``. The exchange
format is the JAX package's: a nested tree in the Flax layout, saved as an
npz with slash-joined keys (``embeddings/word_embeddings/embedding``, ...).
So ``data/encoder_params.npz`` written by either package loads in the other.

Layouts: Flax ``Dense`` kernels are (in, out) and torch ``nn.Linear``
weights are (out, in). The attention q/k/v ``DenseGeneral`` kernels are
(hidden, heads, head_dim) with (heads, head_dim) biases, and the attention
output kernel is (heads, head_dim, hidden). ``Embed`` tables are
``embedding``; ``LayerNorm`` weights are ``scale`` / ``bias``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core.logging import get_logger

from .minilm import MiniLMConfig

logger = get_logger(__name__)

_LN = (("weight", "scale"), ("bias", "bias"))


def load_flax_params(params: dict) -> Dict[str, torch.Tensor]:
    """Flax-layout param tree (numpy or JAX leaves) -> ``MiniLMEncoder``
    state dict (float32 CPU tensors)."""
    t = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    emb = params["embeddings"]
    sd = {
        f"embeddings.{name}.weight": t(emb[name]["embedding"])
        for name in ("word_embeddings", "position_embeddings",
                     "token_type_embeddings")
    }
    for tn, fn in _LN:
        sd[f"embeddings.layer_norm.{tn}"] = t(emb["layer_norm"][fn])
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    for i in range(n_layers):
        p, L = params[f"layer_{i}"], f"layers.{i}"
        att = p["attention"]
        for name in ("query", "key", "value"):
            kern = np.asarray(att[name]["kernel"])  # (h, heads, hd)
            sd[f"{L}.attention.{name}.weight"] = t(kern.reshape(kern.shape[0], -1).T)
            sd[f"{L}.attention.{name}.bias"] = t(np.asarray(att[name]["bias"]).ravel())
        out = np.asarray(att["output"]["kernel"])  # (heads, hd, h)
        sd[f"{L}.attention.output.weight"] = t(out.reshape(-1, out.shape[-1]).T)
        sd[f"{L}.attention.output.bias"] = t(att["output"]["bias"])
        for name in ("intermediate", "ffn_output"):
            sd[f"{L}.{name}.weight"] = t(np.asarray(p[name]["kernel"]).T)
            sd[f"{L}.{name}.bias"] = t(p[name]["bias"])
        for name in ("attention_norm", "ffn_norm"):
            for tn, fn in _LN:
                sd[f"{L}.{name}.{tn}"] = t(p[name][fn])
    return sd


def to_flax_params(state_dict: Dict[str, torch.Tensor], cfg: MiniLMConfig) -> dict:
    """Inverse of :func:`load_flax_params`: state dict -> Flax-layout numpy
    tree, for :func:`export_params`."""
    a = lambda k: state_dict[k].detach().float().cpu().numpy()
    h, heads = cfg.hidden_size, cfg.num_heads
    hd = h // heads
    params = {"embeddings": {
        name: {"embedding": a(f"embeddings.{name}.weight")}
        for name in ("word_embeddings", "position_embeddings",
                     "token_type_embeddings")
    }}
    params["embeddings"]["layer_norm"] = {
        fn: a(f"embeddings.layer_norm.{tn}") for tn, fn in _LN}
    for i in range(cfg.num_layers):
        L = f"layers.{i}"
        att = {
            name: {
                "kernel": a(f"{L}.attention.{name}.weight").T.reshape(h, heads, hd),
                "bias": a(f"{L}.attention.{name}.bias").reshape(heads, hd),
            }
            for name in ("query", "key", "value")
        }
        att["output"] = {
            "kernel": a(f"{L}.attention.output.weight").T.reshape(heads, hd, h),
            "bias": a(f"{L}.attention.output.bias"),
        }
        layer = {"attention": att}
        for name in ("intermediate", "ffn_output"):
            layer[name] = {"kernel": a(f"{L}.{name}.weight").T,
                           "bias": a(f"{L}.{name}.bias")}
        for name in ("attention_norm", "ffn_norm"):
            layer[name] = {fn: a(f"{L}.{name}.{tn}") for tn, fn in _LN}
        params[f"layer_{i}"] = layer
    return params


def convert_bert_state_dict(state: Dict[str, torch.Tensor], cfg: MiniLMConfig) -> dict:
    """HF ``BertModel`` state dict -> Flax-layout numpy tree (the JAX
    package's converter, without JAX)."""
    if not any(k.startswith("embeddings.") for k in state):
        state = {k.removeprefix("bert."): v for k, v in state.items()}
    g = lambda k: state[k].detach().float().cpu().numpy()
    h, heads = cfg.hidden_size, cfg.num_heads
    hd = h // heads
    ln = lambda pre: {"scale": g(pre + ".weight"), "bias": g(pre + ".bias")}
    params = {"embeddings": {
        "word_embeddings": {"embedding": g("embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": g("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {"embedding": g("embeddings.token_type_embeddings.weight")},
        "layer_norm": ln("embeddings.LayerNorm"),
    }}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        att = {
            name: {
                "kernel": g(p + f"attention.self.{name}.weight").T.reshape(h, heads, hd),
                "bias": g(p + f"attention.self.{name}.bias").reshape(heads, hd),
            }
            for name in ("query", "key", "value")
        }
        att["output"] = {
            "kernel": g(p + "attention.output.dense.weight").T.reshape(heads, hd, h),
            "bias": g(p + "attention.output.dense.bias"),
        }
        params[f"layer_{i}"] = {
            "attention": att,
            "attention_norm": ln(p + "attention.output.LayerNorm"),
            "intermediate": {"kernel": g(p + "intermediate.dense.weight").T,
                             "bias": g(p + "intermediate.dense.bias")},
            "ffn_output": {"kernel": g(p + "output.dense.weight").T,
                           "bias": g(p + "output.dense.bias")},
            "ffn_norm": ln(p + "output.LayerNorm"),
        }
    return params


def load_pretrained(model_name: str,
                    cfg: Optional[MiniLMConfig] = None) -> Optional[tuple]:
    """(cfg, Flax-layout params) from a local HF cache, or None when
    ``transformers`` or the checkpoint is unavailable."""
    try:
        import transformers

        hf_cfg = transformers.AutoConfig.from_pretrained(
            model_name, local_files_only=True)
        model = transformers.AutoModel.from_pretrained(
            model_name, local_files_only=True)
    except Exception as e:  # no package, no cache, or no such model
        logger.info("no local HF checkpoint for %s (%s)", model_name, e)
        return None
    cfg = cfg or MiniLMConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
    )
    params = convert_bert_state_dict(dict(model.state_dict()), cfg)
    logger.info("converted HF checkpoint %s", model_name)
    return cfg, params


def export_params(params: dict, path) -> None:
    """Flat-npz export of a Flax-layout tree (slash-joined keys)."""
    flat = {}

    def walk(node, prefix):
        for key in sorted(node):
            val = node[key]
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(val, dict):
                walk(val, name)
            else:
                flat[name] = np.asarray(val)

    walk(params, "")
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)
    logger.info("exported %d param tensors to %s", len(flat), path)


def import_params(path) -> dict:
    """Inverse of export_params: nested numpy tree from the flat npz."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return tree


def infer_config_from_params(params) -> MiniLMConfig:
    """Reconstruct a MiniLMConfig from a param tree's shapes."""
    emb = params["embeddings"]
    vocab, hidden = np.shape(emb["word_embeddings"]["embedding"])
    max_pos = np.shape(emb["position_embeddings"]["embedding"])[0]
    n_layers = sum(1 for k in params if k.startswith("layer_"))
    heads = np.shape(params["layer_0"]["attention"]["query"]["kernel"])[1]
    ffn = np.shape(params["layer_0"]["intermediate"]["kernel"])[1]
    return MiniLMConfig(
        vocab_size=int(vocab), hidden_size=int(hidden), num_layers=n_layers,
        num_heads=int(heads), intermediate_size=int(ffn),
        max_position_embeddings=int(max_pos),
    )


def deterministic_params(cfg: MiniLMConfig, seed: int = 0) -> dict:
    """Offline fallback: reproducible random init, as a Flax-layout tree.

    Drawn from a seeded ``torch.Generator`` with the distributions of
    Flax's default initializers (normal with std 1/sqrt(fan_in) for dense
    kernels and embeddings, zero biases, unit LayerNorm scales). It does
    NOT reproduce the JAX package's bits for the same seed: to compare the
    two packages, give both one parameter file."""
    g = torch.Generator().manual_seed(seed)
    h, heads, ffn = cfg.hidden_size, cfg.num_heads, cfg.intermediate_size
    hd = h // heads

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=g) / fan_in ** 0.5).numpy()

    zeros = lambda *s: np.zeros(s, np.float32)
    ln = lambda: {"scale": np.ones(h, np.float32), "bias": zeros(h)}
    params = {"embeddings": {
        "word_embeddings": {"embedding": normal((cfg.vocab_size, h), h)},
        "position_embeddings": {"embedding": normal((cfg.max_position_embeddings, h), h)},
        "token_type_embeddings": {"embedding": normal((cfg.type_vocab_size, h), h)},
        "layer_norm": ln(),
    }}
    for i in range(cfg.num_layers):
        att = {name: {"kernel": normal((h, heads, hd), h), "bias": zeros(heads, hd)}
               for name in ("query", "key", "value")}
        att["output"] = {"kernel": normal((heads, hd, h), h), "bias": zeros(h)}
        params[f"layer_{i}"] = {
            "attention": att,
            "attention_norm": ln(),
            "intermediate": {"kernel": normal((h, ffn), h), "bias": zeros(ffn)},
            "ffn_output": {"kernel": normal((ffn, h), ffn), "bias": zeros(h)},
            "ffn_norm": ln(),
        }
    return params
