"""Batched text -> embedding pipeline.

Counterpart of ``rag_faiss_embedding_tpu/models/encoder.py`` (the
reference's ``VectorizationPipeline``, ``vectorization.py:19-47``): batch
texts, tokenize on the host, run the encoder on ``device``, pool, and
return a float32 numpy array.

Same resolution order as the JAX pipeline:
- tokenizer: the trained vocab next to trained params -> HF cache ->
  ``vocab_path`` -> trained on demand (``fit_tokenizer``);
- weights: ``params_path`` npz (either package's) -> HF cache ->
  deterministic random init.
Sequences are padded to power-of-two buckets, as in JAX. Unlike JAX, a
short last batch is not padded to ``batch_size`` rows: that pad caps JIT
compiles there, and eager PyTorch compiles nothing per shape.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..core.logging import get_logger

from .. import default_device
from .convert import (
    deterministic_params,
    import_params,
    infer_config_from_params,
    load_flax_params,
    load_pretrained,
)
from .minilm import MiniLMConfig, MiniLMEncoder
from .tokenizer import WordPieceTokenizer

logger = get_logger(__name__)


class EmbeddingPipeline:
    def __init__(
        self,
        model_name: str = "sentence-transformers/all-MiniLM-L6-v2",
        cfg: Optional[MiniLMConfig] = None,
        params: Optional[dict] = None,
        tokenizer: Optional[WordPieceTokenizer] = None,
        pooling: str = "cls",
        normalize: bool = False,
        max_seq_length: int = 512,
        vocab_path: Optional[str | Path] = None,
        params_path: Optional[str | Path] = None,
        device: Optional[torch.device | str] = None,
    ):
        """``params``: a Flax-layout param tree (numpy or JAX leaves), as
        ``convert.import_params`` / ``deterministic_params`` return."""
        self.model_name = model_name
        self.pooling = pooling
        self.normalize = normalize
        self.max_seq_length = max_seq_length
        self.device = torch.device(device) if device is not None else default_device()

        # --- tokenizer. Trained params must meet the vocab they were
        # trained with: mismatched ids index the wrong embedding rows.
        have_trained = (
            params is None and params_path and Path(params_path).exists()
        )
        if tokenizer is None and have_trained and vocab_path and Path(vocab_path).exists():
            tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path)
            logger.info("loaded trained-vocab tokenizer from %s", vocab_path)
        if tokenizer is None:
            tokenizer = WordPieceTokenizer.from_hf_cache(model_name)
        if tokenizer is None and vocab_path and Path(vocab_path).exists():
            tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path)
            logger.info("loaded tokenizer vocab from %s", vocab_path)
        if tokenizer is not None:
            tokenizer.enable_native()  # C++ fast path; silent no-op if absent
        self.tokenizer = tokenizer  # may still be None: call fit_tokenizer
        self.vocab_path = Path(vocab_path) if vocab_path else None

        # --- model weights
        if params is None and params_path and Path(params_path).exists():
            params = import_params(params_path)
            if cfg is None:
                cfg = infer_config_from_params(params)
            logger.info("loaded encoder params from %s", params_path)
        if params is None:
            loaded = load_pretrained(model_name, cfg)
            if loaded is not None:
                cfg, params = loaded
        if cfg is None:
            cfg = MiniLMConfig()
        if params is None:
            logger.warning(
                "no local checkpoint for %s; using deterministic random init "
                "(embeddings are functional but not semantically meaningful)",
                model_name,
            )
            params = deterministic_params(cfg)
        self.cfg = cfg
        self.model = MiniLMEncoder(cfg)
        self.model.load_state_dict(load_flax_params(params))
        self.model.to(self.device).eval()
        logger.debug("initialized embedding pipeline (%s) on %s",
                     model_name, self.device)

    @torch.inference_mode()
    def _forward(self, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
        ids_t = torch.from_numpy(ids).to(self.device, torch.long)
        mask_t = torch.from_numpy(mask).to(self.device)
        emb = self.model(ids_t, mask_t, pooling=self.pooling)
        if self.normalize:
            emb = emb / emb.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return emb

    # ------------------------------------------------------------ tokenizer
    def fit_tokenizer(
        self, corpus: Iterable[str], vocab_size: Optional[int] = None
    ) -> WordPieceTokenizer:
        """Train the fallback WordPiece vocab on a corpus and persist it."""
        vocab_size = vocab_size or min(self.cfg.vocab_size, 30522)
        self.tokenizer = WordPieceTokenizer.train(corpus, vocab_size=vocab_size)
        self.tokenizer.enable_native()
        if self.vocab_path:
            self.tokenizer.save(self.vocab_path)
            logger.info("saved trained vocab to %s", self.vocab_path)
        return self.tokenizer

    def _require_tokenizer(self, texts: Sequence[str]) -> WordPieceTokenizer:
        if self.tokenizer is None:
            logger.warning("no tokenizer vocab available; training on input texts")
            self.fit_tokenizer(texts)
        return self.tokenizer

    # ------------------------------------------------------------- embedding
    def generate_embeddings(
        self,
        texts: Sequence[str],
        batch_size: int = 32,
        show_progress: bool = False,
    ) -> np.ndarray:
        """Batched embed; returns (len(texts), hidden) float32 numpy array
        (the reference ``generate_embeddings``, ``vectorization.py:19``)."""
        texts = list(texts)
        if not texts:
            return np.zeros((0, self.cfg.hidden_size), np.float32)
        tok = self._require_tokenizer(texts)
        ranges = range(0, len(texts), batch_size)
        if show_progress:
            try:
                from tqdm import tqdm

                ranges = tqdm(ranges, desc="Batches")
            except ImportError:
                pass
        out: List[np.ndarray] = []
        for start in ranges:
            batch = texts[start : start + batch_size]
            ids, mask = tok.encode_batch(batch, self.max_seq_length)
            out.append(self._forward(ids, mask).float().cpu().numpy())
        return np.concatenate(out, axis=0)

    def embed_query(self, text: str) -> np.ndarray:
        return self.generate_embeddings([text], batch_size=1)[0]
