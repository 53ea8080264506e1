"""The whole query path, JAX package vs port, on the same files.

Both ``RAGManager``s ingest the same ~40 documents (the example HTML corpus
through the JAX ``HtmlIngestor``, plus seeded synthetic ones) with one
``vocab.txt`` and one ``encoder_params.npz`` at small widths, on the CPU.
Top-5 doc ids must be identical. Distances: rtol 1e-4 / atol 1e-3, because
the two encoders' embeddings agree to ~1e-5 per element (different sum
orders) and an L2 distance sums 32 squared differences of them.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from rag_faiss_embedding_tpu.core import Config as JCfg
from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.ingest import HtmlIngestor
from rag_faiss_embedding_tpu.models import MiniLMConfig as JConfig
from rag_faiss_embedding_tpu.models import convert as jconvert
from rag_faiss_embedding_tpu.models.generator import AnswerGenerator as JGen
from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer
from rag_faiss_embedding_tpu.rag import QueryEngine as JEngine
from rag_faiss_embedding_tpu.rag import RAGManager as JManager
from rag_faiss_embedding_tpu_torch.core import Config as TCfg
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator as TGen
from rag_faiss_embedding_tpu_torch.rag import QueryEngine as TEngine
from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-3
WIDTHS = dict(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=512)
TOPICS = ["vector search", "sqlite storage", "tensor cores", "html parsing",
          "embedding models", "query latency", "index sharding"]


def _documents(tmp: Path):
    docs = HtmlIngestor(output_dir=tmp / "ingest").generate_index(
        REPO / "examples" / "corpus")
    rng = np.random.default_rng(7)
    words = " ".join(docs[0]["content"].split()[:40]).lower().split()
    for i in range(len(docs) + 1, 41):
        picked = " ".join(rng.choice(words, size=12))
        topic = TOPICS[i % len(TOPICS)]
        docs.append({
            "id": i, "url": f"https://synthetic.example/{i}",
            "title": f"synthetic {i}",
            "content": f"Note {i} on {topic}: {picked}. It covers {topic} "
                       f"in {i % 5 + 1} parts.",
        })
    return docs


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    docs = _documents(tmp)
    assert len(docs) == 40
    params = jconvert.deterministic_params(JConfig(**WIDTHS), seed=3)
    tok = WordPieceTokenizer.train([d["content"] for d in docs], vocab_size=2048)
    out = []
    for name in ("jax", "torch"):
        data = tmp / name / "data"
        tok.save(data / "vocab.txt")
        jconvert.export_params(params, data / "encoder_params.npz")
        kw = dict(base_dir=tmp / name, model_name="offline-test")
        if name == "jax":
            m = JManager(config=JCfg(**kw))
            engine = JEngine(m.db, m.vector_store, m.embedder,
                             generator=JGen(backend="extractive"))
        else:
            m = TManager(config=TCfg(**kw), device="cpu")
            engine = TEngine(m.db, m.vector_store, m.embedder,
                             generator=TGen(backend="extractive"))
        assert m.initialize_database(docs) == 40
        out.append((m, engine))
    yield docs, out
    for m, _ in out:
        m.cleanup()


def _same_hits(a, b):
    assert [d["id"] for d in a] == [d["id"] for d in b]
    for key in ("distance", "score"):  # the manager's hits carry no score
        if key in a[0]:
            np.testing.assert_allclose([d[key] for d in a], [d[key] for d in b],
                                       rtol=RTOL, atol=ATOL)


def test_search_matches_jax(managers):
    docs, ((_, je), (tm, te)) = managers
    assert tm.embedder.cfg.hidden_size == 32
    assert tm.vector_store.index.device.type == "cpu"
    for doc in docs[:6] + docs[-3:]:
        t_hits = te.search(doc["content"], top_k=5)
        assert len(t_hits) == 5
        assert t_hits[0]["id"] == doc["id"]  # self-retrieval
        _same_hits(t_hits, je.search(doc["content"], top_k=5))
    _same_hits(te.search("how are vectors stored", top_k=5),
               je.search("how are vectors stored", top_k=5))


def test_search_batch_matches_jax(managers):
    docs, ((_, je), (_, te)) = managers
    queries = [d["content"] for d in docs[::4]] + ["tensor cores"]
    t_rows, j_rows = te.search_batch(queries, top_k=5), je.search_batch(queries, top_k=5)
    assert len(t_rows) == len(queries)
    for t_hits, j_hits in zip(t_rows, j_rows):
        _same_hits(t_hits, j_hits)
    assert te.generate_response("tensor cores", t_rows[-1])


def test_filtered_search_matches_jax(managers):
    docs, ((jm, _), (tm, _)) = managers
    where = {"url_prefix": "https://synthetic.example/"}
    for doc in (docs[0], docs[20]):
        t_hits = tm.search_similar_documents(doc["content"], k=5, where=where)
        j_hits = jm.search_similar_documents(doc["content"], k=5, where=where)
        assert len(t_hits) == 5
        assert all(h["url"].startswith(where["url_prefix"]) for h in t_hits)
        _same_hits(t_hits, j_hits)


def test_saved_indexes_cross_load(managers, tmp_path):
    docs, ((jm, _), (tm, _)) = managers
    queries = np.stack([tm.embedder.embed_query(d["content"]) for d in docs[:4]])
    t_from_j = TStore(index_path=jm.config.index_path, device="cpu")
    j_from_t = JStore(index_path=tm.config.index_path)
    assert t_from_j.doc_ids == jm.vector_store.doc_ids
    assert j_from_t.doc_ids == tm.vector_store.doc_ids
    for loaded, live in ((t_from_j, jm.vector_store), (j_from_t, tm.vector_store)):
        ld, li = loaded.search(queries, k=5)
        vd, vi = live.search(queries, k=5)
        assert li == vi
        for a, b in zip(ld, vd):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


_NO_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    # the slice must run where neither package is installed
    sys.modules["transformers"] = None
    sys.modules["tokenizers"] = None
    from rag_faiss_embedding_tpu_torch.core import Config
    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    cfg = Config(base_dir=sys.argv[1])
    small = MiniLMConfig(vocab_size=256, hidden_size=16, num_layers=1,
                         num_heads=2, intermediate_size=32,
                         max_position_embeddings=64)
    emb = EmbeddingPipeline(cfg=small, max_seq_length=64,
                            vocab_path=cfg.data_dir / "vocab.txt")
    m = RAGManager(cfg, embedder=emb)
    docs = [{"url": f"u{i}", "title": f"t{i}",
             "content": f"document {i} about subject {i * 3 % 7}"}
            for i in range(12)]
    m.initialize_database(docs)
    eng = QueryEngine(m.db, m.vector_store, m.embedder, AnswerGenerator())
    hits = eng.search(docs[4]["content"], top_k=3)
    batch = eng.search_batch([d["content"] for d in docs[:3]], top_k=3)
    answer = eng.generate_response("subject", hits)
    print(json.dumps({
        "hits": [h["id"] for h in hits], "batch": [len(r) for r in batch],
        "answer": bool(answer),
        "loaded": sorted(k for k in sys.modules if k.split(".")[0] in
                         ("jax", "flax", "jaxlib", "rag_faiss_embedding_tpu")),
    }))
""")


def test_port_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("RFE_")}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["hits"][0] == 5 and out["batch"] == [3, 3, 3] and out["answer"]
