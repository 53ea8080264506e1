"""Closed loop of RAG answers with Kimi-Linear as the native generator.

``rag_answer``'s cell with another model: the same questions, chunks,
context budget, answer length, timing and check, every model-free piece
(``vocabulary``, ``prompt_ids``, ``prepare``, ``instrument``, ``window``,
``collect``) taken from there. This module brings what names the model:

- ``plan`` imports the port's Kimi module first, so a program without it
  (the commits before it) fails at once, before anything is built;
- ``weights``: ``reference.kimi_linear.random_weights``, a mapping that
  makes each weight from the seed and its name when it is read, so the
  program's ``load_state_dict`` (which copies them layer by layer into its
  own layout) never holds the routed experts twice;
- ``control`` and ``judge`` against ``reference.kimi_linear``, the same
  numbers as ``rag_answer.judge``: ``logit_rel`` / ``logit_rel_median``
  over the checked calls' positions (the prompt's last, then each cached
  decode step) against one float32 forward over the prompt and the
  answer but its last token.

The configuration's top level is Kimi-Linear-48B-A3B's published
``config.json`` with ``num_experts`` the experts this card holds and
``expert_parallel`` the cards sharing them: the program and the reference
route over all and compute the held experts' part alike.
"""

from __future__ import annotations

import numpy as np

from .. import data
from ..reference import kimi_linear as ref_gen
from . import rag_answer as base
from .rag_answer import collect, instrument, prompt_ids, vocabulary, window  # noqa: F401

_embed, _exact = base._embed, base._exact


def plan(cell: dict, inputs, seed: int, seconds: float) -> dict:
    import rag_faiss_embedding_tpu_torch.models.kimi_linear  # noqa: F401  (the parent has none)

    return base.plan(cell, inputs, seed, seconds)


def weights(inputs, p: dict):
    """Every generator weight under its checkpoint name, made on the card
    in bf16 when read, from the seed."""
    if "weights" not in p:
        p["weights"] = ref_gen.random_weights(p["hf"], data.subseed(inputs.seed, 74),
                                              inputs.device)
    return p["weights"]


def prepare(program, p: dict) -> None:
    """``rag_answer.prepare`` with this model's weights, which its engine
    loads (and lets go) through ``rag_answer.weights``."""
    weights(program.inputs, p)
    base.prepare(program, p)


def _reference(inputs, p: dict, precision: str = "float32"):
    return ref_gen.KimiLinearReference(weights(inputs, p), p["hf"], precision=precision)


def control(inputs, p: dict, mode: str) -> dict:
    """The checked calls as the reference would give them in ``mode``
    ("fp8"), as ``rag_answer.control`` makes them: the exact float32
    retrieval, the prompt written from it, and the logits over the prompt
    and 31 seeded answer tokens."""
    k, n_new = p["t"]["top_k"], inputs.config["port"]["generation_max_length"]
    qs = p["questions"]
    model = _reference(inputs, p, mode)
    r = data.rng(p["seed"], 76)
    out = {"calls": max(p["check"]) + 1, "missing": 0, "short": 0, "hits": {}, "checked": {}}
    for i in p["check"]:
        q = qs[i % len(qs)]
        vals, ids = _exact(inputs, _embed(inputs, [q]), k)
        hits = [(int(j) + 1, float(np.float32(v)), 1.0 / (1.0 + float(np.float32(v))),
                 inputs.corpus.title(int(j))) for v, j in zip(vals[0].tolist(), ids[0].tolist())]
        out["hits"][i % len(qs)] = hits
        prompt = prompt_ids(inputs, p, q, hits)
        answer = r.integers(0, p["hf"]["vocab_size"], size=n_new).tolist()
        logits = model.logits(prompt + answer[:-1], last=n_new).cpu()
        out["checked"][i] = {"prompt": prompt, "answer": answer, "logits": logits, "hits": hits}
    return out


def judge(inputs, p: dict, got: dict) -> dict:
    """``rag_answer.judge``'s numbers (its docstring) with this model's
    reference: the retrieval's from ``rag_answer.judge`` over the calls'
    hits (no logits), the logits' here."""
    checked = got["checked"]
    model = _reference(inputs, p)  # first: rag_answer.judge reads p["weights"] too
    out = base.judge(inputs, p, {**got, "checked": {}})
    made = [i for i in p["check"] if i < got["calls"]]
    missing = out["missing"] - sum(i in checked for i in made)  # rag_answer counted them
    worst = worst_median = 0.0
    mismatch, lengths = 0, []
    qs = p["questions"]
    for i, c in sorted(checked.items()):
        n_new = len(c["answer"])
        want = model.logits(c["prompt"] + c["answer"][:-1], last=n_new).double().cpu()
        have = c["logits"].double()
        if have.shape != want.shape:
            missing += 1
            continue
        err = ((have - want).norm(dim=-1) / want.norm(dim=-1)).nan_to_num(float("inf"))
        worst = max(worst, float(err.max()))
        worst_median = max(worst_median, float(err.median()))
        mismatch += c["prompt"] != prompt_ids(inputs, p, qs[i % len(qs)], c["hits"])
        lengths.append(len(c["prompt"]))
    return {**out, "missing": float(missing),
            "logit_rel": worst if checked else float("inf"),
            "logit_rel_median": worst_median if checked else float("inf"),
            "calls_checked": float(len(checked)), "prompt_tokens": lengths,
            "prompt_mismatch": float(mismatch)}
