"""Answer generation for the RAG stage.

A copy of ``rag_faiss_embedding_tpu/models/generator.py`` that imports no
JAX (importing that module runs ``models/__init__``, which loads the Flax
encoder), plus a backend of its own.

The reference uses an HF ``text2text-generation`` pipeline with FLAN-T5-base,
max_length=200 (``query.py:15-17,95``). This image has no model cache and no
egress, so generation is pluggable:

- "hf": the reference's FLAN-T5 pipeline, used when a local checkpoint cache
  exists (exact capability parity);
- "extractive": dependency-free fallback — selects the retrieved-context
  sentences most relevant to the query by TF cosine and stitches them into a
  short answer. Keeps the RAG loop fully functional offline.
- "native": a decoder on the card, DeepSeek-V2 (``models/deepseek_v2.py``)
  or Kimi-Linear (``models/kimi_linear.py``) as ``config.json``'s
  ``model_type`` names (``deepseek_v2`` or ``kimi_linear``): the prompt
  template, WordPiece tokens, a prefill that fills the model's caches,
  greedy decoding of exactly ``max_length`` tokens through them
  (end-of-sequence is not looked for, so every call has one length), and
  the detokenized answer. ``model_name`` is a directory holding the
  model's ``config.json`` (its ``torch_dtype`` the precision, bf16 where
  none is named) and the tokenizer's ``vocab.txt``. No checkpoint
  file is read yet: the weights come from ``load_state_dict`` (the
  checkpoint's names), and a call before it raises.

The prompt template and the 400-token context budget split across documents
mirror ``query.py:71-92``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from ..core.logging import get_logger
from ..utils.text import cosine_sim, sentence_split, tf_vector
from ..utils.timers import span

logger = get_logger(__name__)


class NativeGenerator:
    """A DeepSeek-V2 or Kimi-Linear decoder on one device behind
    ``generate(prompt)``; ``config.json``'s ``model_type`` chooses
    (``deepseek_v2`` where it names none).

    ``keep``: a list while set; each call then appends its prompt ids, its
    answer ids and the float32 logits it chose them from (``[answer,
    vocab]`` on the device: the prefill's last position, then each decode
    step). ``last_ids``: the last call's answer ids."""

    def __init__(self, model_name: str, answer_tokens: int, device=None):
        import json

        import torch

        from .. import default_device
        from .tokenizer import WordPieceTokenizer

        path = Path(model_name)
        for name in ("config.json", "vocab.txt"):
            if not (path / name).is_file():
                raise ValueError(f"no {name} in {model_name!r}: the native generator reads "
                                 "a DeepSeek-V2 or Kimi-Linear config.json and its vocab.txt")
        hf = json.loads((path / "config.json").read_text())
        kind = hf.get("model_type", "deepseek_v2")
        if kind == "deepseek_v2":
            from .deepseek_v2 import DeepseekV2 as Model, DeepseekV2Config as ModelConfig
        elif kind == "kimi_linear":
            from .kimi_linear import KimiLinear as Model, KimiLinearConfig as ModelConfig
        else:
            raise ValueError(f"model_type {kind!r}: the native generator runs deepseek_v2 "
                             "and kimi_linear")
        cfg = ModelConfig.from_hf(hf)
        tokenizer = WordPieceTokenizer.from_vocab_file(path / "vocab.txt")
        if tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(f"a tokenizer of {tokenizer.vocab_size} ids for a model of "
                             f"{cfg.vocab_size}")
        if answer_tokens < 1:
            raise ValueError("answer_tokens must be positive")
        self.tokenizer = tokenizer
        self.tokenizer.enable_native()
        self.answer_tokens = answer_tokens
        self.device = torch.device(device) if device is not None else default_device()
        self.model = Model(cfg, self.device)
        self.keep: Optional[list] = None
        self.last_ids: List[int] = []

    def load_state_dict(self, sd) -> None:
        self.model.load_state_dict(sd)

    def generate(self, prompt: str) -> str:
        with span("generator.generate") as s:
            limit = self.model.cfg.max_position_embeddings - self.answer_tokens + 1
            ids = self.tokenizer.encode(prompt, max_length=limit)
            out = self.generate_ids(ids)
            s.add(prompt_tokens=len(ids), new_tokens=len(out))
            return self.tokenizer.decode(out)

    def generate_ids(self, ids: List[int]) -> List[int]:
        """Greedy: exactly ``answer_tokens`` ids after the prompt ``ids``.
        Every decode step is queued before any of their tokens is read back
        (a step's input is the token before it, already on the device);
        each token follows its step into pinned host memory and is read as
        soon as that step ends. So the card runs the steps back to back,
        whatever the host's pace."""
        import numpy as np
        import torch

        model, n = self.model, len(ids)
        if not model.loaded:
            raise RuntimeError("the native generator has no weights: load_state_dict first")
        model.reserve(n + self.answer_tokens - 1)
        prompt = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(self.device)
        with span("generator.prefill", tokens=n) as s:
            logits = model.prefill(prompt)
            token = logits.argmax()
            if s:
                s.add(**model.prefill_counts())
            with span("generator.to_host"):
                out = [int(token)]
        # the kept logits in one buffer, a block the caching allocator holds
        # already, not a new small block a step
        kept = None if self.keep is None else logits.new_empty((self.answer_tokens, *logits.shape))
        if kept is not None:
            kept[0] = logits
        cuda = self.device.type == "cuda"
        host = torch.empty(self.answer_tokens - 1, dtype=torch.long, pin_memory=cuda)
        with span("generator.decode", steps=self.answer_tokens - 1, context=n) as s:
            done = []
            for j, pos in enumerate(range(n, n + self.answer_tokens - 1)):
                logits = model.decode(token, pos)
                token = logits.argmax()
                host[j].copy_(token, non_blocking=True)
                done.append(torch.cuda.Event() if cuda else None)
                if cuda:
                    done[-1].record()
                if kept is not None:
                    kept[j + 1] = logits
            for j, event in enumerate(done):
                with span("generator.to_host"):
                    if event is not None:
                        event.synchronize()
                    out.append(int(host[j]))
            if s:  # after the last step's token: no wait of its own
                s.add(**model.decode_counts())
        if kept is not None:
            self.keep.append({"prompt": list(ids), "answer": out, "logits": kept})
        self.last_ids = out
        return out


class AnswerGenerator:
    def __init__(
        self,
        model_name: str = "google/flan-t5-base",
        backend: str = "auto",  # "auto" | "hf" | "extractive" | "native"
        max_length: int = 200,
        min_length: int = 20,
        device=None,
    ):
        """``device``: the native backend's (default: the card)."""
        self.model_name = model_name
        self.max_length = max_length
        self.min_length = min_length
        self._pipe = None
        self.native: Optional[NativeGenerator] = None
        if backend == "native":
            self.native = NativeGenerator(model_name, max_length, device)
            self.backend = "native"
            logger.info("using native generator %s", model_name)
        elif backend in ("auto", "hf"):
            try:
                from transformers import pipeline

                self._pipe = pipeline(
                    "text2text-generation",
                    model=model_name,
                    max_length=max_length,
                    model_kwargs={"local_files_only": True},
                )
                self.backend = "hf"
                logger.info("using HF generator %s", model_name)
            except Exception as e:
                if backend == "hf":
                    raise
                logger.info(
                    "no local generator checkpoint (%s); using extractive backend", e
                )
                self.backend = "extractive"
        else:
            self.backend = "extractive"

    @classmethod
    def from_config(cls, cfg, device=None) -> "AnswerGenerator":
        """The generator ``cfg`` (a ``core.config.Config``) names:
        ``generator_backend``, ``generator_model`` and
        ``generation_max_length``."""
        return cls(cfg.generator_model, cfg.generator_backend, cfg.generation_max_length,
                   device=device)

    def load_state_dict(self, sd) -> None:
        """The native backend's weights (checkpoint names)."""
        if self.native is None:
            raise ValueError(f"the {self.backend} backend takes no state dict")
        self.native.load_state_dict(sd)

    def build_prompt(self, query: str, context: str) -> str:
        """Reference prompt template (``query.py:88-92``)."""
        return (
            f"Based on the following documents, provide a brief answer to "
            f"this question: {query}\n\n"
            f"Context:\n{context}\n\n"
            f"Answer:"
        )

    def generate(self, query: str, context: str) -> str:
        if self.native is not None:
            return self.native.generate(self.build_prompt(query, context))
        if self.backend == "hf":
            out = self._pipe(
                self.build_prompt(query, context),
                max_length=self.max_length,
                min_length=self.min_length,
            )
            return out[0]["generated_text"].strip()
        return self._extractive(query, context)

    def _extractive(self, query: str, context: str) -> str:
        qv = tf_vector(query)
        # Context lines alternate "Document N (...):" headers and content;
        # strip headers, then sentence-split the content lines.
        sentences = []
        for line in context.splitlines():
            line = line.strip()
            if not line or line.startswith("Document "):
                continue
            sentences.extend(sentence_split(line) or [line])
        scored = []
        for sent in sentences:
            if len(sent.split()) < 3:
                continue
            scored.append((cosine_sim(qv, tf_vector(sent)), sent))
        scored.sort(key=lambda x: -x[0])
        picked: List[str] = []
        budget = self.max_length  # ~words, approximating the token budget
        for score, sent in scored:
            if score <= 0:
                break
            words = len(sent.split())
            if words > budget:
                continue
            picked.append(sent)
            budget -= words
            if len(picked) >= 3:
                break
        if not picked:
            return "No relevant information found in the retrieved documents."
        return " ".join(picked)
