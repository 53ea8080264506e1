"""Closed loop of ``RAGManager.add_documents`` into the live store.

Parameters (the cell file's ``params``): ``docs_per_call`` new documents a
call; ``words``: their lengths, log-normal (``median``, ``sigma``) clipped
to [``lo``, ``hi``]; ``max_calls``, the most calls a window can make (the
pool of new documents); ``check_docs``, how many added documents the output
check reads back.

Each document is a window of the corpus's word stream at a new url. The
manager embeds them at its own batch size, inserts them into SQLite and
appends their vectors to the index. The rate counts the rows the calls
made searchable over the time from the first call to the last return.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import data
from ..reference.minilm import MiniLM
from ..reference.wordpiece import WordPiece


def plan(cell: dict, inputs, seed: int, seconds: float) -> dict:
    t = cell["params"]
    w = t["words"]
    n = t["max_calls"] * t["docs_per_call"] + t["docs_per_call"]  # the last: warm-up
    lengths = data.fixed_then_shuffled(
        seed, 40, data.lognormal_lengths(n, w["median"], w["sigma"], w["lo"], w["hi"]))
    spans = data.windows(inputs.corpus.stream, seed, 41, lengths)
    return {"t": t, "seed": seed, "spans": spans}


def docs(inputs, p: dict, call: int) -> list:
    """Call ``call``'s documents; call -1 is the warm-up's."""
    per = p["t"]["docs_per_call"]
    first = (call if call >= 0 else p["t"]["max_calls"]) * per
    stream = inputs.corpus.stream
    return [{"url": f"https://corpus.example/new/{j}", "title": f"new {j}",
             "content": stream.window(int(s), int(n))}
            for j, (s, n) in enumerate(p["spans"][first:first + per], first)]


def prepare(program, p: dict) -> None:
    """The corpus in SQLite; the encoder at every length bucket a batch can
    fall in; one call of the traffic (its shapes, and the index's growth
    past the corpus)."""
    program.db
    mgr, stream = program.manager, program.inputs.corpus.stream
    for n_words in (4, 12, 24, 48, 100, 200, p["t"]["words"]["hi"]):
        mgr.embedder.generate_embeddings([stream.window(0, n_words)] * mgr.config.batch_size,
                                         batch_size=mgr.config.batch_size)
    mgr.add_documents(docs(program.inputs, p, -1))
    program.sync()


def instrument(program, spans) -> None:
    emb, tok = program.embedder, program.tokenizer
    spans.wrap(program.manager, "add_documents", "manager.add_documents",
               lambda a, kw, out: {"rows": out})
    spans.wrap(emb, "generate_embeddings", "embedder.generate_embeddings",
               lambda a, kw, out: {"rows": len(out)})
    spans.wrap(tok, "encode_batch", "tokenizer.encode_batch",
               lambda a, kw, out: {"real": out[1].sum(1).tolist(), "positions": out[1].size})
    spans.wrap(program.store, "add_vectors", "vector_store.add_vectors",
               lambda a, kw, out: {"rows": len(a[1])})
    db = program.db
    spans.wrap(db, "insert_documents", "db.insert_documents",
               lambda a, kw, out: {"rows": len(out)})
    spans.wrap(db, "get_document_id_by_url", "db.get_document_id_by_url")


def window(program, p: dict, seconds: float, dev) -> dict:
    mgr, inputs = program.manager, program.inputs
    rows = attempted = calls = 0
    with dev.window():
        t0 = time.monotonic_ns()
        end = t0 + int(seconds * 1e9)
        for call in range(p["t"]["max_calls"]):
            batch = docs(inputs, p, call)
            attempted += len(batch)
            rows += mgr.add_documents(batch)
            calls += 1
            e = time.monotonic_ns()
            if e >= end:
                break
        else:
            raise RuntimeError("the pool of new documents ran out inside the window: "
                               "raise max_calls")
    return {"t0": t0, "t1": e, "window_s": (e - t0) / 1e9, "attempted": attempted,
            "failed": attempted - rows, "done": {"rows": rows}, "calls": calls}


def _sample(p: dict, calls: int) -> list:
    """Which added documents the check reads back: a seeded sample, with the
    longest added one in it."""
    n = calls * p["t"]["docs_per_call"]
    pick = random.Random(data.subseed(p["seed"], 42)).sample(range(n), min(n, p["t"]["check_docs"]))
    longest = int(np.argmax(p["spans"][:n, 1]))
    return sorted(set(pick) | {longest})


def collect(program, p: dict, rec: dict) -> dict:
    """What the program holds for each sampled document: its id by url, the
    stored document, the stored vector, and the top hit of a search for
    that vector (which must be the document itself)."""
    db, store = program.db, program.store
    sample = _sample(p, rec["calls"])
    first_new = program.inputs.n_rows  # rows past the corpus are the added ones
    pos_of = {d: first_new + i for i, d in enumerate(store.doc_ids[first_new:])}
    out = {}
    vectors = store.index.vectors()  # host copy of the stored rows
    for j in sample:
        url = f"https://corpus.example/new/{j}"
        doc_id = db.get_document_id_by_url(url)
        pos = pos_of.get(doc_id)
        stored = vectors[pos] if pos is not None else None
        hit = store.search(stored, 1)[1] if stored is not None else []
        doc = db.get_document_by_id(doc_id) if doc_id is not None else None
        out[j] = {"id": doc_id, "doc": doc, "vector": stored, "hit": hit[:1]}
    return out


def control(inputs, p: dict, mode: str) -> dict:
    """The sampled documents as a program computing its embeddings in
    ``mode`` ("tf32") would store them: ids and documents as they should
    be."""
    calls = p["t"]["max_calls"]
    enc = _encoder(inputs, mode)
    out = {}
    for j in _sample(p, calls):
        doc = docs(inputs, p, j // p["t"]["docs_per_call"])[j % p["t"]["docs_per_call"]]
        vec = enc(doc["content"]).cpu().numpy()
        out[j] = {"id": j + 1, "doc": {**doc, "id": j + 1}, "vector": vec, "hit": [j + 1]}
    return out


def _encoder(inputs, precision: str = "float32"):
    tok = WordPiece(inputs.vocab.tokens)
    model = MiniLM(inputs.weights, inputs.model, precision)
    max_len = inputs.config["port"]["max_seq_length"]
    return lambda text: model.embed(tok.encode(text, max_len))


def judge(inputs, p: dict, got: dict) -> dict:
    """``missing``: sampled documents not found by url, stored wrong, or
    whose vector's top hit is another id; ``emb_rel``: the widest relative
    distance of a stored vector from the reference's embedding."""
    per = p["t"]["docs_per_call"]
    enc = _encoder(inputs)
    missing, worst = 0, 0.0
    for j, g in sorted(got.items()):
        want = docs(inputs, p, j // per)[j % per]
        doc = g["doc"] or {}
        if (g["id"] is None or g["vector"] is None or g["hit"] != [g["id"]]
                or any(doc.get(f) != want[f] for f in ("url", "title", "content"))):
            missing += 1
            continue
        e = enc(want["content"]).double().cpu()
        v = torch.as_tensor(np.asarray(g["vector"]), dtype=torch.float64)
        worst = max(worst, float((v - e).norm() / e.norm()))
    return {"missing": float(missing), "emb_rel": worst, "docs_checked": float(len(got))}
