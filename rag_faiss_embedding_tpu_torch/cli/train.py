"""Contrastive training CLI: fine-tune the encoder on a corpus.

Counterpart of ``rag_faiss_embedding_tpu/cli/train.py``, over every visible
card (or the CPU with ``--device cpu``). Training pairs are self-supervised
from the document store: (title + first sentence, full content) plus two random
crops of the same content, drawn from the numpy ``Generator`` exactly as the
JAX CLI draws them, so one seed gives both packages the same pairs and the
same token batches. InfoNCE over the batch (``parallel/train.py``),
checkpoints through ``parallel/checkpoint.py``, and the trained parameters
exported as the Flax-layout ``encoder_params.npz`` that both packages'
``EmbeddingPipeline(params_path=...)`` load (``RAGManager`` picks it up from
``data_dir``), with the trained vocabulary beside it.

The mesh is JAX's: n devices make ``{"data": n // m, "model": m}`` with m
the first of 4 and 2 that divides n and is smaller than it, else 1 (1 card:
1 x 1, 2: 2 x 1, 4: 2 x 2, 8: 2 x 4); ``parallel/train.py`` trains over it.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..core.logging import get_logger
from ..core.mesh import _visible_cards, make_mesh
from ..models.convert import export_params, to_flax_params
from ..models.minilm import MiniLMConfig
from ..models.tokenizer import WordPieceTokenizer
from ..utils.text import sentence_split

logger = get_logger(__name__)


def make_pairs(documents: List[Dict], rng: np.random.Generator) -> List[Tuple[str, str]]:
    """Self-supervised (query, positive) pairs from a document corpus."""
    pairs = []
    for doc in documents:
        content = doc.get("content", "").strip()
        if not content:
            continue
        title = doc.get("title", "")
        sents = sentence_split(content)
        head = sents[0] if sents else content[:80]
        pairs.append((f"{title} {head}".strip(), content))
        words = content.split()
        if len(words) >= 16:
            # two random crops of the same doc as an extra positive pair
            half = len(words) // 2
            a = rng.integers(0, max(1, len(words) - half))
            b = rng.integers(0, max(1, len(words) - half))
            pairs.append((" ".join(words[a:a + half]), " ".join(words[b:b + half])))
    return pairs


def batch_iterator(
    pairs: List[Tuple[str, str]],
    tokenizer: WordPieceTokenizer,
    batch_size: int,
    max_len: int,
    seed: int = 0,
) -> Iterator[dict]:
    """Endless (B, max_len) int32 token batches, as CPU tensors."""
    rng = np.random.default_rng(seed)
    while True:
        idx = rng.choice(len(pairs), size=batch_size, replace=len(pairs) < batch_size)
        q_ids, q_mask = tokenizer.encode_batch([pairs[i][0] for i in idx], max_len,
                                               bucketed=False)
        d_ids, d_mask = tokenizer.encode_batch([pairs[i][1] for i in idx], max_len,
                                               bucketed=False)

        def pad(x):
            if x.shape[1] < max_len:
                x = np.pad(x, ((0, 0), (0, max_len - x.shape[1])))
            return torch.from_numpy(x)

        yield {"q_ids": pad(q_ids), "q_mask": pad(q_mask),
               "d_ids": pad(d_ids), "d_mask": pad(d_mask)}


def train(
    documents: List[Dict],
    cfg: Optional[MiniLMConfig] = None,
    steps: int = 100,
    batch_size: int = 32,
    max_len: int = 128,
    learning_rate: float = 2e-5,
    vocab_size: int = 8192,
    checkpoint_dir: Optional[str | Path] = None,
    params_out: Optional[str | Path] = None,
    seed: int = 0,
    log_every: int = 10,
    pooling: str = "mean",
    device: Optional[torch.device | str | Sequence] = None,
):
    """Run the contrastive training loop; returns (params as a Flax-layout
    numpy tree, gathered from the mesh, and the tokenizer). ``device``: one
    device, a sequence of them (repeats allowed) to build the mesh over, or
    None for every visible card (none raises)."""
    from ..parallel.train import make_train_step

    if device is None:
        devices = _visible_cards()
    elif isinstance(device, (str, torch.device)):
        devices = [torch.device(device)]
    else:
        devices = [torch.device(d) for d in device]
    rng = np.random.default_rng(seed)
    pairs = make_pairs(documents, rng)
    if not pairs:
        raise ValueError("no usable training pairs in the corpus")
    logger.info("training on %d pairs", len(pairs))
    tokenizer = WordPieceTokenizer.train(
        [p[0] for p in pairs] + [p[1] for p in pairs], vocab_size=vocab_size)

    cfg = cfg or MiniLMConfig(vocab_size=max(tokenizer.vocab_size, 128))
    n_dev = len(devices)
    model_par = next((c for c in (4, 2) if n_dev % c == 0 and n_dev > c), 1)
    mesh = make_mesh({"data": n_dev // model_par, "model": model_par}, devices=devices)
    logger.info("mesh: %s", dict(mesh.shape))
    run_step, state = make_train_step(cfg, mesh, learning_rate=learning_rate, pooling=pooling)
    ckpt = None
    if checkpoint_dir:
        from ..parallel.checkpoint import TrainCheckpointer

        ckpt = TrainCheckpointer(checkpoint_dir)

    batches = batch_iterator(pairs, tokenizer, batch_size, max_len, seed)
    for step in range(1, steps + 1):
        state, metrics = run_step(state, next(batches))
        if step % log_every == 0 or step == steps:
            logger.info("step %d/%d loss=%.4f acc=%.3f", step, steps,
                        float(metrics["loss"]), float(metrics["accuracy"]))
    if ckpt:
        ckpt.save(state)
        ckpt.close()
    params = to_flax_params(state.params.state_dict(), cfg)
    if params_out:
        export_params(params, params_out)
    return params, tokenizer


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Contrastively train the encoder")
    parser.add_argument("--base-dir", default=".")
    parser.add_argument("--documents", default=None,
                        help="documents.json (default: config's)")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--max-len", type=int, default=128)
    parser.add_argument("--lr", type=float, default=2e-5)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--params-out", default=None)
    parser.add_argument("--device", default=None,
                        help="one torch device (default: every visible CUDA card, on "
                             "JAX's mesh; 'cpu' only when asked)")
    args = parser.parse_args(argv)

    config = Config.from_env(base_dir=args.base_dir)
    # train with the pooling the deployment serves with (config.pooling)
    doc_path = Path(args.documents or config.documents_json)
    documents = json.loads(doc_path.read_text())
    params_out = args.params_out or (config.data_dir / "encoder_params.npz")
    _, tokenizer = train(
        documents,
        steps=args.steps,
        batch_size=args.batch_size,
        max_len=args.max_len,
        learning_rate=args.lr,
        checkpoint_dir=args.checkpoint_dir,
        params_out=params_out,
        pooling=config.pooling,
        device=args.device,
    )
    tokenizer.save(config.data_dir / "vocab.txt")
    logger.info("training complete; params at %s", params_out)


if __name__ == "__main__":
    main()
