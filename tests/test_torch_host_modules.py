"""The port's own host modules, and that it imports nothing of the JAX package.

The port carries copies of the JAX package's framework-free host modules
(``core.config``, ``core.logging``, ``store.database``, ``utils.text``,
``native``). These tests hold each copy to its original on the same inputs,
and check, by an ``ast`` scan and in a fresh process, that no module of the
port (nor ``chip_smoke.py``) imports ``jax``, ``flax`` or
``rag_faiss_embedding_tpu``.
"""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from rag_faiss_embedding_tpu.core.config import Config as JCfg
from rag_faiss_embedding_tpu.native import NativeWordPiece as JNative
from rag_faiss_embedding_tpu.store.database import Database as JDatabase
from rag_faiss_embedding_tpu.utils import text as jtext
from rag_faiss_embedding_tpu_torch import native as tnative
from rag_faiss_embedding_tpu_torch.core.config import Config as TCfg
from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer
from rag_faiss_embedding_tpu_torch.store.database import Database as TDatabase
from rag_faiss_embedding_tpu_torch.utils import text as ttext

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "rag_faiss_embedding_tpu_torch"
FORBIDDEN = ("jax", "flax", "rag_faiss_embedding_tpu")
SOURCES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]


def _imported(path: Path):
    """Top-level package names of every absolute import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("source", SOURCES)
def test_no_source_imports_the_jax_package(source):
    bad = sorted(set(_imported(REPO / source)) & set(FORBIDDEN))
    assert not bad, f"{source} imports {bad}"


_NO_JAX_SCRIPT = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    sys.modules["transformers"] = None  # as where neither is installed
    sys.modules["tokenizers"] = None
    import rag_faiss_embedding_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    from rag_faiss_embedding_tpu_torch.core import Config
    from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig
    from rag_faiss_embedding_tpu_torch.models.generator import AnswerGenerator
    from rag_faiss_embedding_tpu_torch.rag import QueryEngine, RAGManager

    cfg = Config(base_dir=sys.argv[1])
    small = MiniLMConfig(vocab_size=256, hidden_size=16, num_layers=1, num_heads=2,
                         intermediate_size=32, max_position_embeddings=64)
    emb = EmbeddingPipeline(cfg=small, max_seq_length=64, device="cpu",
                            vocab_path=cfg.data_dir / "vocab.txt")
    m = RAGManager(cfg, embedder=emb, device="cpu")
    docs = [{"url": f"u{i}", "title": f"t{i}", "content": f"note {i} on topic {i % 3}"}
            for i in range(20)]
    m.initialize_database(docs)
    hits = QueryEngine(m.db, m.vector_store, m.embedder, AnswerGenerator()).search(
        docs[7]["content"], top_k=3)
    print(json.dumps({
        "modules": len(names), "hits": [h["id"] for h in hits],
        "loaded": sorted(k for k in sys.modules
                         if k.split(".")[0] in ("jax", "flax", "jaxlib",
                                                "rag_faiss_embedding_tpu")),
    }))
""")


def test_port_loads_no_jax_module(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("RFE_")}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT, str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["modules"] > 30 and out["hits"][0] == 8


@pytest.fixture
def no_rfe_env(monkeypatch):
    for key in [k for k in os.environ if k.startswith("RFE_")]:
        monkeypatch.delenv(key)


def test_configs_are_equal(no_rfe_env, tmp_path):
    assert dataclasses.asdict(JCfg()) == dataclasses.asdict(TCfg())
    kw = dict(base_dir=tmp_path, index_kind="ivf", ivf_nlist=64, index_metric="IP")
    assert dataclasses.asdict(JCfg(**kw)) == dataclasses.asdict(TCfg(**kw))
    (tmp_path / ".env").write_text("RFE_TOP_K=7\nRFE_IVF_BALANCE='reassign'\n# note\n")
    a, b = JCfg.from_env(tmp_path, batch_size=8), TCfg.from_env(tmp_path, batch_size=8)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (b.top_k, b.ivf_balance, b.batch_size) == (7, "reassign", 8)
    for cls in (JCfg, TCfg):
        with pytest.raises(ValueError, match="index_metric"):
            cls(index_metric="cosine")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_databases_read_each_other(tmp_path, writer):
    path = tmp_path / "documents.db"
    write_cls, read_cls = (JDatabase, TDatabase) if writer == "jax" else (TDatabase, JDatabase)
    db = write_cls(path)
    docs = [{"url": f"https://d.example/{i}", "title": f"t{i}", "content": f"body {i}"}
            for i in range(5)] + [{"id": 42, "url": "https://d.example/x", "title": "x",
                                   "content": "explicit id"}]
    ids = db.insert_documents(docs)
    db.delete_documents([ids[1]])
    db.close()
    other, again = read_cls(path), write_cls(path)
    assert other.fetch_all_documents() == again.fetch_all_documents()
    assert len(other.fetch_all_documents()) == 5
    assert other.get_document_by_id(42)["content"] == "explicit id"
    assert other.select_ids({"url_prefix": "https://d.example/"}) == \
        again.select_ids({"url_prefix": "https://d.example/"})
    other.close()
    again.close()


def test_text_utilities_agree():
    rng = np.random.default_rng(0)
    words = ["Dr.", "Smith", "met", "the", "team", "at", "3pm.", "It", "rained!", "Why?",
             "e.g.", "vectors", "Index", "(IVF)", "Mr.", "Jones", "left.", "42", "\"Yes\""]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(3, 40)))) for _ in range(50)]
    texts += ["", "   ", "One. Two! Three? four", "Prof. X et al. wrote it. Then more."]
    for t in texts:
        assert ttext.sentence_split(t) == jtext.sentence_split(t)
        assert ttext.tf_vector(t) == jtext.tf_vector(t)
    for a, b in zip(texts, texts[1:]):
        va, vb = ttext.tf_vector(a), ttext.tf_vector(b)
        assert ttext.cosine_sim(va, vb) == jtext.cosine_sim(va, vb)


def test_native_tokenizers_agree_on_the_corpus():
    pages = sorted((REPO / "examples" / "corpus").glob("*.html"))
    texts = [" ".join(re.sub(r"<[^>]+>", " ", p.read_text(encoding="utf-8")).split())
             for p in pages]
    assert texts
    texts += [t[: len(t) // 3] for t in texts] + ["naïve café", ""]
    vocab = WordPieceTokenizer.train(texts, vocab_size=1024).vocab
    so = tnative.build_native()
    assert so is not None and PORT / "_build" in so.parents
    jtok, ttok = JNative(vocab), tnative.NativeWordPiece(vocab)
    for t in texts:
        for max_length in (16, 512):
            assert ttok.encode(t, max_length) == jtok.encode(t, max_length)
    ascii_texts = [t for t in texts if t.isascii()]
    for a, b in zip(jtok.encode_batch(ascii_texts, 128), ttok.encode_batch(ascii_texts, 128)):
        np.testing.assert_array_equal(a, b)
