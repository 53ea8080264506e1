"""Closed loop of RAG answers: ``QueryEngine.search``, then ``generate_response``.

Parameters (the cell file's ``params``): ``questions`` seeded questions of
``words`` = [lo, hi] words, asked in order and cycled; ``top_k`` chunks a
question; ``check_calls`` calls whose logits the check reads, drawn from
the seed among the first ``check_within``.

One caller. A call embeds the question (MiniLM), scans the flat index
(K1), fetches the chunks from SQLite, and has the program's native
generator (``models/deepseek_v2.py``) answer from them: each chunk cut to
its share of ``context_token_budget``, a prefill over the whole prompt,
then greedy decoding through the latent cache. A call is timed from the
question to the answer's text on the host.

The generator is built as the server builds it, from the program's
``Config`` (``serve.api.build_generator``): ``generator_model`` is a
directory in the run directory holding the configuration's published
``config.json`` (the configuration file's top level) and the seeded
``vocab.txt``; the seeded weights, made on the card in bf16, go to
``load_state_dict``. A program without the native generator (the
commits before it) fails at ``plan``, before anything is built.
"""

from __future__ import annotations

import dataclasses
import json
import random
import string
import time

import numpy as np
import torch

from .. import data
from ..reference import deepseek_v2 as ref_gen
from ..reference import search as ref
from ..reference.minilm import MiniLM
from ..reference.wordpiece import WordPiece

# the configuration file's own keys; every other top-level key is the
# generator's published config.json
HARNESS_KEYS = ("source", "model", "encoder", "port", "corpus", "rows", "index", "deployment",
                "assumed", "reduced")
# whole calls before the window: with two, the window's first calls ran
# 10-20 ms slower than the rest on an H100's host
WARM_CALLS = 6


def generator_config(config: dict) -> dict:
    return {k: v for k, v in config.items() if k not in HARNESS_KEYS}


def plan(cell: dict, inputs, seed: int, seconds: float) -> dict:
    import rag_faiss_embedding_tpu_torch.models.deepseek_v2  # noqa: F401  (the parent has none)

    t = cell["params"]
    lo, hi = t["words"]
    lengths = data.fixed_then_shuffled(
        seed, 70, lambda g: g.integers(lo, hi + 1, size=t["questions"]))
    spans = data.windows(inputs.corpus.stream, seed, 71, lengths)
    questions = [inputs.corpus.stream.window(int(s), int(n)) for s, n in spans]
    check = sorted(random.Random(data.subseed(seed, 72)).sample(range(t["check_within"]),
                                                                t["check_calls"]))
    return {"t": t, "seed": seed, "questions": questions, "check": check,
            "hf": generator_config(inputs.config)}


# ------------------------------------------------------------ the inputs
def vocabulary(inputs, p: dict) -> list:
    """The generator's vocabulary: the encoder's 30,522 entries, then seeded
    lowercase words (80%) and ``##`` pieces up to the model's vocab_size."""
    if "vocab" not in p:
        base = list(inputs.vocab.tokens)
        taken, extra = set(base), []
        r = data.rng(inputs.seed, 73)
        letters = np.array(list(string.ascii_lowercase))
        n_extra = p["hf"]["vocab_size"] - len(base)
        n_words = int(n_extra * 0.8)
        while len(extra) < n_extra:
            piece = len(extra) >= n_words
            ln = int(r.integers(2, 6) if piece else r.integers(4, 13))
            tok = ("##" if piece else "") + "".join(letters[r.integers(0, 26, size=ln)])
            if tok not in taken:
                taken.add(tok)
                extra.append(tok)
        p["vocab"] = base + extra
    return p["vocab"]


def weights(inputs, p: dict) -> dict:
    """Every generator weight under its checkpoint name, bf16 on the card,
    from the seed (``reference.deepseek_v2.random_weights``)."""
    if "weights" not in p:
        p["weights"] = ref_gen.random_weights(p["hf"], data.subseed(inputs.seed, 74),
                                              inputs.device)
    return p["weights"]


def _engine(program, p: dict):
    """The engine over the program's store, with the generator its
    ``Config`` names, built as the server builds it."""
    if "engine" not in p:
        from rag_faiss_embedding_tpu_torch.rag.engine import QueryEngine
        from rag_faiss_embedding_tpu_torch.serve.api import build_generator

        folder = program.workdir / "generator"
        folder.mkdir(parents=True, exist_ok=True)
        (folder / "config.json").write_text(json.dumps(p["hf"]))
        (folder / "vocab.txt").write_text("\n".join(vocabulary(program.inputs, p)) + "\n")
        cfg = dataclasses.replace(program.port_config, generator_model=str(folder))
        gen = build_generator(cfg, program.embedder)
        gen.load_state_dict(weights(program.inputs, p))
        del p["weights"]  # the program holds its own copy; the check makes them again
        p["engine"] = QueryEngine(program.db, program.store, program.embedder, generator=gen,
                                  context_token_budget=cfg.context_token_budget)
    return p["engine"]


# ------------------------------------------------------------ the window
def prepare(program, p: dict) -> None:
    """The corpus in SQLite, the index, the generator; every question's
    search once (each of the query encoder's shapes), then ``WARM_CALLS``
    whole calls."""
    program.db
    engine = _engine(program, p)
    t, qs = p["t"], p["questions"]
    for q in qs:
        engine.search(q, top_k=t["top_k"])
    for i in range(WARM_CALLS):
        q = qs[i % len(qs)]
        engine.generate_response(q, engine.search(q, top_k=t["top_k"]))
    program.sync()


def instrument(program, spans) -> None:
    spans.wrap(program.store, "search", "vector_store.search",
               lambda a, kw, out: {"q": a[0], "k": a[1]})
    spans.wrap(program.tokenizer, "encode_batch", "tokenizer.encode_batch",
               lambda a, kw, out: {"real": out[1].sum(1).tolist(), "positions": out[1].size})


def window(program, p: dict, seconds: float, dev) -> dict:
    t, qs = p["t"], p["questions"]
    engine = _engine(program, p)
    native = engine.generator.native
    check = set(p["check"])
    rng = random.Random(data.subseed(p["seed"], 75))
    lat, seen, hits, checked = [], {}, {}, {}
    missing = short = 0
    with dev.window():
        t0 = time.monotonic_ns()
        end = t0 + int(seconds * 1e9)
        i = 0
        while True:
            q = qs[i % len(qs)]
            native.last_ids = []
            native.keep = [] if i in check else None
            s = time.monotonic_ns()
            docs = engine.search(q, top_k=t["top_k"])
            engine.generate_response(q, docs)  # no chunks, or a failure: no new ids
            e = time.monotonic_ns()
            lat.append((e - s) / 1e6)
            if not native.last_ids:
                missing += 1
            short += len(docs) < t["top_k"] or 0 < len(native.last_ids) < native.answer_tokens
            found = [(d["id"], d["distance"], d["score"], d["title"]) for d in docs]
            if native.keep:
                checked[i] = {**native.keep[0], "hits": found}
            native.keep = None
            b = i % len(qs)
            seen[b] = seen.get(b, 0) + 1
            if rng.random() * seen[b] < 1:  # one retrieval a question, drawn from the seed
                hits[b] = found
            i += 1
            if e >= end:
                break
    return {"t0": t0, "t1": e, "window_s": (e - t0) / 1e9, "latencies_ms": lat,
            "attempted": i, "failed": missing + short, "done": {"answers": i - missing},
            "calls": i, "missing": missing, "short": short, "hits": hits, "checked": checked}


def collect(program, p: dict, rec: dict) -> dict:
    """The window's counts, one retrieval a question, the checked calls'
    logits on the host; the engine (and its cache) let go."""
    checked = {i: {**c, "logits": c["logits"].float().cpu()} for i, c in rec["checked"].items()}
    p.pop("engine", None)
    return {"calls": rec["calls"], "missing": rec["missing"], "short": rec["short"],
            "hits": rec["hits"], "checked": checked}


# ------------------------------------------------------------- the check
def _decode(tokens: list, ids: list) -> str:
    """Tokens back to text as a WordPiece decoder joins them: specials
    dropped, ``##`` pieces glued to the word before."""
    out = ""
    for i in ids:
        tok = tokens[i]
        if tok in ("[PAD]", "[CLS]", "[SEP]"):
            continue
        out += tok[2:] if tok.startswith("##") else (" " if out else "") + tok
    return out


def prompt_ids(inputs, p: dict, question: str, hits: list) -> list:
    """The prompt a RAG engine writes for ``hits`` ((id, distance, score,
    title) each): every chunk cut to its share of the context budget in
    encoder tokens, headed by its rank, score and title, under the
    template; then the generator's tokens."""
    enc = WordPiece(inputs.vocab.tokens)
    share = max(1, inputs.config["port"]["context_token_budget"] // len(hits))
    parts = []
    for r, (doc_id, _, score, title) in enumerate(hits, 1):
        text = _decode(inputs.vocab.tokens, enc.encode(inputs.corpus.content(doc_id - 1), share + 2))
        parts.append(f"Document {r} (Score: {score:.3f}, Title: {title}):\n{text}\n")
    prompt = ("Based on the following documents, provide a brief answer to this question: "
              f"{question}\n\nContext:\n" + "\n".join(parts) + "\n\nAnswer:")
    # BERT splits on "\n" as on a space; reference.wordpiece drops it as a
    # control character, which would join the words on either side
    return WordPiece(vocabulary(inputs, p)).encode(prompt.replace("\n", " "), 1 << 30)


def _embed(inputs, texts: list) -> torch.Tensor:
    tok = WordPiece(inputs.vocab.tokens)
    model = MiniLM(inputs.weights, inputs.model)
    return model.embed_many([tok.encode(x, inputs.config["port"]["max_seq_length"])
                             for x in texts])


def _exact(inputs, q: torch.Tensor, k: int):
    ex = ref.Exact(q, k)
    ex.add(inputs.shard(0), 0)
    return ex.result()


def control(inputs, p: dict, mode: str) -> dict:
    """The checked calls as the reference would give them in ``mode``
    ("fp8"): the exact float32 retrieval, the prompt written from it, and
    the logits of the reference with fp8 products over the prompt and 31
    seeded answer tokens (the reference has no cache to decode greedily
    with; the check compares logits, whatever the tokens)."""
    k, n_new = p["t"]["top_k"], inputs.config["port"]["generation_max_length"]
    qs = p["questions"]
    model = ref_gen.DeepseekV2Reference(weights(inputs, p), p["hf"], precision=mode)
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
    """``missing``: calls with no answer, and checked calls the window never
    made; ``short``: calls with fewer than top_k chunks or answer tokens;
    ``rank_gap`` and ``dist_rel`` as in ``vector_search.judge``, one call a
    question, against the reference's own embedding of the question and
    its float64 exact top-k; ``logit_rel``: the largest, over the checked
    calls' positions (the prompt's last, then each cached decode step), of
    ||program - reference|| / ||reference|| of the logits, the reference
    one float32 forward over the prompt and the answer but its last token;
    ``logit_rel_median``: the largest over the checked calls of the median
    over a call's positions (a fault moves every position, or every decode
    step's, where bf16 alone moves a few positions far: a router choice
    flipped near a tie; so the median is the one limited, ``logit_rel``
    information); ``prompt_mismatch``: checked calls whose prompt ids are
    not those the reference writes from the same chunks (each chunk's
    share of the budget, the template, the generator's tokens)."""
    k = p["t"]["top_k"]
    qs = p["questions"]
    made = [i for i in p["check"] if i < got["calls"]]
    missing = got["missing"] + sum(i not in got["checked"] for i in made) + len(p["check"]) - len(
        made)
    short = got["short"]
    asked = sorted(got["hits"])
    q = _embed(inputs, [qs[b] for b in asked])
    ref_v, _ = _exact(inputs, q, k)
    ids = torch.ones(len(asked), k, dtype=torch.long)
    reported = torch.zeros(len(asked), k, dtype=torch.float64)
    have = torch.zeros(len(asked), k, dtype=torch.bool)
    for j, b in enumerate(asked):
        hits = [h for h in got["hits"][b] if isinstance(h[0], int) and 1 <= h[0] <= inputs.n_rows]
        short += len(hits) < k
        for r, h in enumerate(hits[:k]):
            ids[j, r], reported[j, r], have[j, r] = h[0], h[1], True
    rows = inputs.rows_of((ids - 1).flatten().to(inputs.device)).view(len(asked), k, -1)
    exact = ref.distances(q.to(inputs.device)[:, None, :], rows).cpu()
    rel = ((reported - exact).abs() / exact.clamp_min(1e-12))[have]
    gap = ((exact - ref_v) / ref_v.clamp_min(1e-12))[have]
    model = ref_gen.DeepseekV2Reference(weights(inputs, p), p["hf"])
    worst = worst_median = 0.0
    mismatch, lengths = 0, []
    for i, c in sorted(got["checked"].items()):
        n_new = len(c["answer"])
        want = model.logits(c["prompt"] + c["answer"][:-1], last=n_new).double().cpu()
        have_l = c["logits"].double()
        if have_l.shape != want.shape:
            missing += 1
            continue
        err = ((have_l - want).norm(dim=-1) / want.norm(dim=-1)).nan_to_num(float("inf"))
        worst = max(worst, float(err.max()))
        worst_median = max(worst_median, float(err.median()))
        mismatch += c["prompt"] != prompt_ids(inputs, p, qs[i % len(qs)], c["hits"])
        lengths.append(len(c["prompt"]))
    return {"missing": float(missing), "short": float(short),
            "rank_gap": float(gap.max()) if len(gap) else float("inf"),
            "dist_rel": float(rel.max()) if len(rel) else float("inf"),
            "logit_rel": worst if got["checked"] else float("inf"),
            "logit_rel_median": worst_median if got["checked"] else float("inf"),
            "calls": float(got["calls"]), "questions_checked": float(len(asked)),
            "calls_checked": float(len(got["checked"])), "prompt_tokens": lengths,
            "prompt_mismatch": float(mismatch)}
