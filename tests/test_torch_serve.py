"""The port's HTTP server against the JAX package's, on the CPU.

``tests/test_serve.py``'s ten cases, run against the port's server
(``rag_faiss_embedding_tpu_torch.serve.api``, standard library only), then
the same requests sent to both servers, built from the same encoder weights
and the same documents: the same statuses, JSON keys and ids, scores and
distances within ``tests/test_torch_slice.py``'s tolerance. Then what only
the port has: one worker thread for every engine call, writes interleaved
with concurrent searches, the HTTP reader, the client and the entry point.

Every server binds port 0, every wait is bounded, and every server is
stopped in a ``finally``.
"""

import asyncio
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.models import EmbeddingPipeline as JEmb
from rag_faiss_embedding_tpu.models.generator import AnswerGenerator as JGen
from rag_faiss_embedding_tpu.rag import QueryEngine as JEngine
from rag_faiss_embedding_tpu.serve.api import make_app as jmake_app
from rag_faiss_embedding_tpu.store import Database as JDatabase
from rag_faiss_embedding_tpu_torch.core import Config as TCfg
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline as TEmb
from rag_faiss_embedding_tpu_torch.models import MiniLMConfig as TConfig
from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator as TGen
from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer as TWordPiece
from rag_faiss_embedding_tpu_torch.rag import QueryEngine as TEngine
from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager
from rag_faiss_embedding_tpu_torch.serve import api
from rag_faiss_embedding_tpu_torch.serve.api import SearchService, make_app
from rag_faiss_embedding_tpu_torch.serve.client import APISearch
from rag_faiss_embedding_tpu_torch.store import Database as TDatabase

from .test_rag import DOCS, SMALL
from .test_torch_slice import _same_hits

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 60.0
TSMALL = TConfig(**{f: getattr(SMALL, f) for f in (
    "vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
    "max_position_embeddings")})


def _embedders():
    """The JAX test encoder and the port's, with the same weights and one
    vocab (the trainer may order tied tokens differently from run to run)."""
    jemb = JEmb(model_name="offline-test", cfg=SMALL, max_seq_length=64)
    jemb.fit_tokenizer([d["content"] for d in DOCS], vocab_size=300)
    params = jax.tree_util.tree_map(np.asarray, jemb.params)
    temb = TEmb(model_name="offline-test", cfg=TSMALL, params=params, max_seq_length=64,
                tokenizer=TWordPiece(dict(jemb.tokenizer.vocab)), device="cpu")
    return jemb, temb


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX engine, port engine) over the same three documents."""
    tmp = tmp_path_factory.mktemp("torch_serve")
    jemb, temb = _embedders()
    out = []
    for name, db_cls, store_cls, eng_cls, gen_cls, emb in (
            ("jax", JDatabase, JStore, JEngine, JGen, jemb),
            ("torch", TDatabase, TStore, TEngine, TGen, temb)):
        db = db_cls(tmp / name / "docs.db")
        ids = db.insert_documents(DOCS)
        kw = {} if name == "jax" else {"device": "cpu"}
        store = store_cls(dimension=32, index_path=tmp / name / "idx", **kw)
        if name == "jax":
            store.index._use_pallas = False
        store.add_vectors(emb.generate_embeddings([d["content"] for d in DOCS]), ids)
        out.append(eng_cls(db, store, emb, generator=gen_cls(backend="extractive")))
    return out


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def _request(port, method, path, body=None, raw=None):
    """One HTTP request to the port's server: (status, JSON body, headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        data = raw if raw is not None else (None if body is None else json.dumps(body))
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read()), dict(resp.getheaders())
    finally:
        conn.close()


def _serve(engine, run, config=None, manager=None):
    """Start the port's server on a free port, ``await run(port, app)``, stop."""
    async def main():
        app = make_app(engine, config or TCfg(base_dir="/tmp"), manager=manager)
        port = await asyncio.wait_for(app.start("127.0.0.1", 0), WAIT_S)
        try:
            return await asyncio.wait_for(run(port, app), WAIT_S)
        finally:
            await asyncio.wait_for(app.stop(), WAIT_S)

    return asyncio.run(main())


async def _call(port, method, path, body=None, raw=None):
    return await asyncio.to_thread(_request, port, method, path, body, raw)


def _client_call(engine, requests, config=None, manager=None):
    """The port's answers to (method, path, body) requests, one at a time."""
    async def run(port, app):
        return [(await _call(port, m, p, b))[:2] for m, p, b in requests]

    return _serve(engine, run, config, manager)


def _port_manager(tmp_path_factory, name):
    """A port RAGManager over DOCS, with the JAX test encoder's weights."""
    _, temb = _embedders()
    cfg = TCfg(base_dir=tmp_path_factory.mktemp(name), vector_dimension=32,
               serve_watchdog_interval_s=0)
    manager = TManager(config=cfg, embedder=temb, device="cpu")
    manager.initialize_database(DOCS)
    return manager, cfg


# ---------------------------------------------------- tests/test_serve.py
def test_health(engine):
    [(status, body)] = _client_call(engine, [("GET", "/health", None)])
    assert status == 200
    assert body["status"] == "healthy"
    assert body["documents"] == 3 and body["vectors"] == 3


def test_search_contract(engine):
    [(status, body)] = _client_call(
        engine, [("POST", "/search", {"text": DOCS[0]["content"], "top_k": 2})]
    )
    assert status == 200
    docs = body["similar_documents"]
    assert len(docs) == 2
    assert docs[0]["id"] == 9
    assert {"id", "url", "title", "content", "score", "distance"} <= set(docs[0])
    assert isinstance(body["generated_response"], str)
    assert body["generated_response"]


def test_search_without_generation(engine):
    [(status, body)] = _client_call(
        engine,
        [("POST", "/search", {"text": "jax", "top_k": 1, "generate": False})],
    )
    assert status == 200
    assert "generated_response" not in body


def test_search_validation_errors(engine):
    results = _client_call(engine, [
        ("POST", "/search", {"top_k": 3}),
        ("POST", "/search", {"text": "", "top_k": 3}),
        ("POST", "/search", {"text": "x", "top_k": 0}),
        ("POST", "/search", {"text": "x", "top_k": "three"}),
    ])
    assert [s for s, _ in results] == [422, 422, 422, 422]


def test_concurrent_requests_are_batched(engine):
    async def run(port, app):
        async def one(i):
            _, body, _ = await _call(port, "POST", "/search", {
                "text": DOCS[i % 3]["content"], "top_k": 1, "generate": False})
            return body["similar_documents"][0]["id"]

        ids = await asyncio.gather(*[one(i) for i in range(12)])
        return ids, (await _call(port, "GET", "/stats"))[1]

    ids, stats = _serve(engine, run)
    assert ids == [9, 4, 1] * 4
    # at least one multi-query batch must have been coalesced
    assert any("n=" in k and k != "batch_search(n=1)" for k in stats), stats


def test_watchdog_reports_health(engine):
    """The self-probe flips /health to 503 when the search path dies."""
    cfg = TCfg(base_dir="/tmp", serve_watchdog_interval_s=0.05)

    async def run(port, app):
        await asyncio.sleep(0.3)
        r1 = await _call(port, "GET", "/health")
        original = engine.search_batch
        engine.search_batch = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("device lost"))
        try:
            await asyncio.sleep(0.3)
            r2 = await _call(port, "GET", "/health")
        finally:
            engine.search_batch = original
        return (r1[0], r1[1]["status"]), (r2[0], r2[1]["status"], r2[1]["watchdog_error"])

    ok, broken = _serve(engine, run, cfg)
    assert ok == (200, "healthy")
    assert broken == (503, "unhealthy", "device lost")


def test_add_documents_endpoint(tmp_path_factory):
    """Streaming adds over HTTP: new docs are searchable immediately."""
    tm, cfg = _port_manager(tmp_path_factory, "torch_serve_add")
    eng = TEngine(tm.db, tm.vector_store, tm.embedder, generator=TGen(backend="extractive"))
    new_doc = {"id": 77, "url": "https://ex/new", "title": "new.html",
               "content": "pallas kernels tile vector memory"}

    async def run(port, app):
        r = await _call(port, "POST", "/documents", {"documents": [new_doc]})
        r2 = await _call(port, "POST", "/search", {
            "text": new_doc["content"], "top_k": 1, "generate": False})
        r3 = await _call(port, "POST", "/documents", {"documents": []})
        r4 = await _call(port, "POST", "/documents", {"documents": [{"x": 1}]})
        return r[0], r[1], r2[1]["similar_documents"][0]["id"], r3[0], r4[0]

    status, added, hit, bad1, bad2 = _serve(eng, run, cfg, tm)
    assert status == 200 and added["added"] == 1 and added["vectors"] == 4
    assert hit == 77
    assert bad1 == 422 and bad2 == 422


def test_add_documents_disabled_without_manager(engine):
    [(status, body)] = _client_call(
        engine, [("POST", "/documents", {"documents": [{"url": "u", "content": "c"}]})]
    )
    assert status == 501


def test_delete_documents_endpoint(tmp_path_factory):
    """DELETE /documents removes from both stores; bad bodies are 422."""
    tm, cfg = _port_manager(tmp_path_factory, "torch_serve_del")
    eng = TEngine(tm.db, tm.vector_store, tm.embedder, generator=TGen(backend="extractive"))

    async def run(port, app):
        r = await _call(port, "DELETE", "/documents", {"ids": [9], "urls": ["https://ex/db"]})
        r2 = await _call(port, "POST", "/search", {
            "text": DOCS[0]["content"], "top_k": 3, "generate": False})
        r3 = await _call(port, "DELETE", "/documents", {})
        r4 = await _call(port, "DELETE", "/documents", {"ids": "nope"})
        return r[0], r[1], [d["id"] for d in r2[1]["similar_documents"]], r3[0], r4[0]

    status, deleted, hits, bad1, bad2 = _serve(eng, run, cfg, tm)
    assert status == 200 and deleted["deleted"] == 2
    assert deleted["documents"] == 1
    assert hits == [4]  # only tpu.html remains searchable
    assert bad1 == 422 and bad2 == 422


def test_delete_documents_disabled_without_manager(engine):
    [(status, _)] = _client_call(engine, [("DELETE", "/documents", {"ids": [1]})])
    assert status == 501


# ---------------------------------------------------- the two servers agree
PARITY_REQUESTS = [
    ("GET", "/health", None, None),
    ("POST", "/search", {"text": DOCS[0]["content"], "top_k": 2}, None),
    ("POST", "/search", {"text": DOCS[1]["content"], "top_k": 3, "generate": False}, None),
    ("POST", "/search", {"text": "sqlite database", "top_k": 5, "generate": False}, None),
    ("POST", "/search", {"text": "arrays", "top_k": 2,
                         "filter": {"url_prefix": "https://ex/t"}}, None),
    ("POST", "/search", {"text": "arrays", "top_k": 2, "filter": {"no_such_key": 1}}, None),
    ("POST", "/search", {"text": "arrays", "filter": [1]}, None),
    ("POST", "/search", {"text": "  ", "top_k": 2}, None),
    ("POST", "/search", {"text": "x", "top_k": -1}, None),
    ("POST", "/search", None, "{not json"),
    ("POST", "/search", None, ""),
    ("POST", "/documents", {"documents": [{"url": "u", "content": "c"}]}, None),
    ("DELETE", "/documents", {"ids": [1]}, None),
    ("GET", "/stats", None, None),
    ("GET", "/nowhere", None, None),
    ("GET", "/search", None, None),
    ("PUT", "/documents", {}, None),
]


def _jax_answers(engine, requests):
    from aiohttp.test_utils import TestClient, TestServer

    async def run():
        client = TestClient(TestServer(jmake_app(engine)))
        await client.start_server()
        try:
            out = []
            for method, path, body, raw in requests:
                kw = {"data": raw} if raw is not None else {"json": body}
                resp = await asyncio.wait_for(client.request(method, path, **kw), WAIT_S)
                json_body = (await resp.json()) if resp.content_type == "application/json" \
                    else None
                out.append((resp.status, json_body))
            return out
        finally:
            await client.close()

    return asyncio.run(run())


def _port_answers(engine, requests):
    async def run(port, app):
        return [(await _call(port, m, p, b, raw))[:2] for m, p, b, raw in requests]

    return _serve(engine, run)


def test_port_server_answers_as_the_jax_server(engines):
    jax_engine, port_engine = engines
    j = _jax_answers(jax_engine, PARITY_REQUESTS)
    t = _port_answers(port_engine, PARITY_REQUESTS)
    assert [s for s, _ in t] == [s for s, _ in j] == [
        200, 200, 200, 200, 200, 422, 422, 422, 422, 400, 400, 501, 501, 200, 404, 405, 405]
    for (method, path, _, _), (_, jb), (_, tb) in zip(PARITY_REQUESTS, j, t):
        if jb is None or path == "/stats":  # aiohttp's 404 / 405 are text
            continue
        assert set(tb) == set(jb), (method, path)
        if "similar_documents" in jb:
            if jb["similar_documents"]:
                _same_hits(tb["similar_documents"], jb["similar_documents"])
            else:
                assert tb["similar_documents"] == []
            for a, b in zip(tb["similar_documents"], jb["similar_documents"]):
                assert set(a) == set(b)
        elif "detail" not in jb:
            assert tb == jb
    assert t[4][1]["similar_documents"][0]["url"] == "https://ex/tpu"


def test_both_servers_batch_at_the_largest_top_k(engines):
    """Co-riders with different top_k each get their own count of hits, cut
    from one search at the batch's largest k."""
    _, port_engine = engines
    calls = []
    original = port_engine.search_batch

    def spy(texts, k):
        calls.append((len(texts), k))
        return original(texts, k)

    port_engine.search_batch = spy
    try:
        async def run(port, app):
            bodies = [{"text": DOCS[i % 3]["content"], "top_k": 1 + i % 3,
                       "generate": False} for i in range(9)]
            return await asyncio.gather(*[_call(port, "POST", "/search", b) for b in bodies])

        answers = _serve(port_engine, run, TCfg(base_dir="/tmp", serve_watchdog_interval_s=0))
    finally:
        port_engine.search_batch = original
    assert [len(a[1]["similar_documents"]) for a in answers] == [1, 2, 3] * 3
    assert sum(n for n, _ in calls) == 9
    assert any(n > 1 and k == 3 for n, k in calls), calls


# ---------------------------------------------------- what only the port has
def test_every_engine_call_runs_on_one_worker_thread(tmp_path_factory):
    tm, cfg = _port_manager(tmp_path_factory, "torch_serve_thread")
    eng = TEngine(tm.db, tm.vector_store, tm.embedder, generator=TGen(backend="extractive"))
    threads = {}

    def spy(obj, name):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            threads.setdefault(name, set()).add(threading.get_ident())
            return fn(*a, **k)

        setattr(obj, name, wrapped)

    for obj, name in ((eng, "search_batch"), (eng, "search"), (eng, "generate_response"),
                      (tm, "add_documents"), (tm, "delete_documents")):
        spy(obj, name)

    async def run(port, app):
        loop_thread = threading.get_ident()
        await app.probe()
        await asyncio.gather(*[_call(port, "POST", "/search", {"text": d["content"]})
                               for d in DOCS * 3])
        await _call(port, "POST", "/search", {"text": "x", "filter": {"url_prefix": "h"}})
        await _call(port, "POST", "/documents", {"documents": [
            {"url": "https://ex/w", "title": "w", "content": "worker thread document"}],
            "persist": True})
        await _call(port, "DELETE", "/documents", {"urls": ["https://ex/w"]})
        return loop_thread

    loop_thread = _serve(eng, run, cfg, tm)
    assert set(threads) == {"search_batch", "search", "generate_response",
                            "add_documents", "delete_documents"}
    used = set().union(*threads.values())
    assert len(used) == 1 and loop_thread not in used


def test_writes_interleaved_with_searches(tmp_path_factory):
    """POST /documents while 48 searches run: every id a search returns is
    in SQLite, and each added document is found once its POST returned."""
    tm, cfg = _port_manager(tmp_path_factory, "torch_serve_writes")
    eng = TEngine(tm.db, tm.vector_store, tm.embedder, generator=TGen(backend="extractive"))
    words = " ".join(d["content"] for d in DOCS).split()
    rng = np.random.default_rng(0)
    new = [{"id": 100 + i, "url": f"https://ex/new{i}", "title": f"new{i}",
            "content": " ".join(rng.choice(words, size=8))} for i in range(6)]

    async def run(port, app):
        async def searcher(i):
            _, body, _ = await _call(port, "POST", "/search", {
                "text": DOCS[i % 3]["content"] if i % 2 else new[i % 6]["content"],
                "top_k": 5, "generate": False})
            return [h["id"] for h in body["similar_documents"]]

        async def writer(doc):
            status, body, _ = await _call(port, "POST", "/documents", {"documents": [doc]})
            assert status == 200 and body["added"] == 1
            _, hit, _ = await _call(port, "POST", "/search", {
                "text": doc["content"], "top_k": 1, "generate": False})
            return hit["similar_documents"][0]["id"]

        results = await asyncio.gather(*[searcher(i) for i in range(48)],
                                       *[writer(d) for d in new])
        return results[:48], results[48:]

    hit_lists, found = _serve(eng, run, cfg, tm)
    assert found == [d["id"] for d in new]
    known = {d["id"] for d in tm.db.fetch_all_documents()}
    assert known == {d["id"] for d in DOCS + new}
    assert all(hits and set(hits) <= known for hits in hit_lists)
    assert tm.vector_store.ntotal == len(DOCS) + len(new)


def test_a_failed_batch_fails_every_co_rider(engine):
    """SearchService: the batch's exception reaches each of its requests."""
    boom = RuntimeError("kernel launch failed")
    original = engine.search_batch
    engine.search_batch = lambda *a, **k: (_ for _ in ()).throw(boom)

    async def run():
        service = SearchService(engine, max_batch=8, batch_timeout_ms=20)
        await service.start()
        try:
            return await asyncio.wait_for(asyncio.gather(
                *[service.search("q", 1) for _ in range(5)], return_exceptions=True), WAIT_S)
        finally:
            await service.stop()

    try:
        errors = asyncio.run(run())
    finally:
        engine.search_batch = original
    assert all(e is boom for e in errors)


def test_http_framing(engine):
    """Keep-alive, Content-Length / Content-Type on every response, a body
    split across packets, ``Expect: 100-continue``, and 400 / 413 from the
    reader."""
    def exchange(port):
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
            body = json.dumps({"text": DOCS[0]["content"], "top_k": 1,
                               "generate": False}).encode()
            head = (f"POST /search HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}"
                    "\r\n\r\n").encode()
            s.sendall(head + body[:5])
            s.sendall(body[5:])
            s.sendall(b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n")
            f = s.makefile("rb")
            answers = []
            for _ in range(2):
                status = f.readline().decode()
                headers = {}
                while (line := f.readline()) not in (b"\r\n", b""):
                    k, _, v = line.decode().partition(":")
                    headers[k.lower()] = v.strip()
                answers.append((status.split()[1], headers,
                                json.loads(f.read(int(headers["content-length"])))))
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
            body = json.dumps({"text": DOCS[1]["content"], "generate": False}).encode()
            s.sendall(f"POST /search HTTP/1.1\r\nContent-Length: {len(body)}\r\n"
                      "Expect: 100-continue\r\nConnection: close\r\n\r\n".encode())
            f = s.makefile("rb")
            interim = f.readline().split()[1]  # before the body is sent, as curl waits
            f.readline()
            s.sendall(body)
            expected = (interim, f.readline().split()[1])
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
            s.sendall(b"NONSENSE\r\n\r\n")
            bad = s.makefile("rb").readline().split()[1]
        with socket.create_connection(("127.0.0.1", port), timeout=WAIT_S) as s:
            s.sendall(f"POST /search HTTP/1.1\r\nContent-Length: {api.MAX_BODY_BYTES + 1}"
                      "\r\n\r\n".encode())
            big = s.makefile("rb").readline().split()[1]
        return answers, expected, bad, big

    async def run(port, app):
        return await asyncio.to_thread(exchange, port)

    answers, expected, bad, big = _serve(engine, run)
    assert [a[0] for a in answers] == ["200", "200"]
    assert all(h["content-type"].startswith("application/json") for _, h, _ in answers)
    assert answers[0][2]["similar_documents"][0]["id"] == 9
    assert answers[1][2]["documents"] == 3
    assert expected == (b"100", b"200")
    assert (bad, big) == (b"400", b"413")


def test_client_queries_the_port_server(engine, capsys):
    async def run(port, app):
        ok = await APISearch(api_url=f"http://127.0.0.1:{port}/search",
                             top_k=2).query_once(None, DOCS[0]["content"])
        missing = await APISearch(api_url=f"http://127.0.0.1:{port}/nowhere").query_once(
            None, "x")
        return ok, missing

    ok, missing = _serve(engine, run)
    assert [d["id"] for d in ok["similar_documents"]][0] == 9 and ok["generated_response"]
    assert missing is None
    APISearch().print_results(ok["similar_documents"], interactive=False)
    out = capsys.readouterr().out
    assert "server replied 404" in out and "jax.html" in out and "Score" in out
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    assert asyncio.run(APISearch(api_url=f"http://127.0.0.1:{dead}/search")
                       .query_once(None, "x")) is None
    assert "cannot reach" in capsys.readouterr().out


def test_main_needs_the_card_unless_asked(tmp_path, monkeypatch):
    """The entry point serves on the card by default: with none visible it
    raises instead of serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.main(["--base-dir", str(tmp_path), "--port", "0"])


def test_main_serves_on_the_cpu_when_asked(tmp_path):
    """``python -m ...serve.api --device cpu`` builds its index from
    documents.json, serves, and answers."""
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "documents.json").write_text(json.dumps(DOCS))
    env = {k: v for k, v in os.environ.items() if not k.startswith("RFE_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "rag_faiss_embedding_tpu_torch.serve.api", "--base-dir",
         str(tmp_path), "--host", "127.0.0.1", "--port", "0", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        lines = []

        def read():  # libraries may print before the server's line
            for out in proc.stdout:
                lines.append(out)
                if out.startswith("serving on"):
                    return

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(timeout=240)
        line = lines[-1] if lines else ""
        assert line.startswith("serving on http://127.0.0.1:"), lines
        port = int(line.rsplit(":", 1)[1])
        status, health, _ = _request(port, "GET", "/health")
        status2, body, _ = _request(port, "POST", "/search",
                                    {"text": DOCS[2]["content"], "top_k": 1})
    finally:
        proc.terminate()
        proc.wait(timeout=WAIT_S)
    assert status == 200 and health["documents"] == 3 and health["vectors"] == 3
    assert status2 == 200 and body["similar_documents"][0]["id"] == 1
    assert body["generated_response"]
