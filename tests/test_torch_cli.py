"""The port's CLIs against the JAX package's, on the CPU.

``tests/test_cli.py``'s seven cases, each run through both packages'
CLIs over managers built with the same encoder weights and vocab: the same
hits (ids, distances within ``tests/test_torch_slice.py``'s tolerance) and
the same counts. Then the CLIs' ``main`` entry points on the CPU
(``--device cpu``), and their refusal to run without a card by default.
"""

import json
import os

import pytest
import torch

from rag_faiss_embedding_tpu.cli import admin as jadmin
from rag_faiss_embedding_tpu.cli import ingest_json as jingest
from rag_faiss_embedding_tpu.cli import pipeline as jpipeline
from rag_faiss_embedding_tpu.cli import search as jsearch
from rag_faiss_embedding_tpu.cli import selfindex as jselfindex
from rag_faiss_embedding_tpu.core import Config as JCfg
from rag_faiss_embedding_tpu.rag import RAGManager as JManager
from rag_faiss_embedding_tpu_torch.cli import admin as tadmin
from rag_faiss_embedding_tpu_torch.cli import ingest_json as tingest
from rag_faiss_embedding_tpu_torch.cli import pipeline as tpipeline
from rag_faiss_embedding_tpu_torch.cli import search as tsearch
from rag_faiss_embedding_tpu_torch.cli import selfindex as tselfindex
from rag_faiss_embedding_tpu_torch.core import Config as TCfg
from rag_faiss_embedding_tpu_torch.rag import RAGManager as TManager
from rag_faiss_embedding_tpu_torch.store import Database as TDatabase

from .test_rag import DOCS
from .test_torch_serve import _embedders
from .test_torch_slice import REPO, _same_hits

SITE_PAGE = ("<html><body><main><p>JAX compiles numerical programs with XLA "
             "for TPU accelerators. It traces python functions.</p></main>"
             "</body></html>")
RAW = [
    {"url": "example.com/good", "title": "Good",
     "content": "this document easily has more than ten words of real "
                "content inside it. definitely enough."},
    {"url": "", "title": "bad", "content": "too short"},
]


@pytest.fixture
def managers(tmp_path):
    """(JAX manager, port manager): the same encoder, DOCS in documents.json."""
    jemb, temb = _embedders()
    out = []
    for name, cfg_cls, cls, emb, kw in (("jax", JCfg, JManager, jemb, {}),
                                        ("torch", TCfg, TManager, temb, {"device": "cpu"})):
        base = tmp_path / name
        (base / "data").mkdir(parents=True)
        (base / "data" / "documents.json").write_text(json.dumps(DOCS))
        m = cls(config=cfg_cls(base_dir=base, vector_dimension=32), embedder=emb, **kw)
        if name == "jax":
            m.vector_store.index._use_pallas = False
        out.append(m)
    yield out
    for m in out:
        m.cleanup()


def test_cli_search_one_shot(managers, capsys):
    results = []
    for m, mod in zip(managers, (jsearch, tsearch)):
        m.initialize_database()
        cli = mod.CLISearch(manager=m)
        results.append(cli.search(DOCS[0]["content"], k=2))
    j, t = results
    assert t[0]["id"] == 9
    _same_hits(t, j)
    capsys.readouterr()
    tsearch.CLISearch(manager=managers[1]).print_results(t, interactive=False)
    out = capsys.readouterr().out
    assert "jax.html" in out and "Similarity" in out
    assert out.index("jax.html") < out.index(t[1]["title"])


def test_cli_similarity_convention():
    # 1/(1+distance) display convention (2-cli-rag-search.py:48)
    for cls in (jsearch.CLISearch, tsearch.CLISearch):
        assert cls.similarity({"distance": 0.0}) == 1.0
        assert cls.similarity({"distance": 3.0}) == 0.25


def test_cli_empty_results_panel(managers, capsys):
    m = managers[1]
    m.initialize_database()
    tsearch.CLISearch(manager=m).print_results([], interactive=False)
    assert "no matches" in capsys.readouterr().out


def test_admin_tool_flow(managers, capsys):
    outs = []
    for m, mod in zip(managers, (jadmin, tadmin)):
        admin = mod.AdminTool(manager=m)
        counts = [admin.initialize(), admin.document_count(), admin.verify_system()]
        admin.test_search(DOCS[2]["content"])
        out = capsys.readouterr().out
        assert "VERIFY: OK" in out and "db.html" in out
        # option 8: deletion by id and by url (persists both stores)
        counts += [admin.delete_document("4"), admin.delete_document("https://ex/jax"),
                   admin.delete_document("https://nope"), admin.document_count()]
        results = admin.manager.search_similar_documents(DOCS[0]["content"], k=3)
        outs.append((counts, [r["id"] for r in results]))
    assert outs[0] == outs[1] == ([3, 3, True, 1, 1, 0, 1], [1])


def test_process_python_files(tmp_path):
    (tmp_path / "a.py").write_text("print('hello')\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.py").write_text("x = 1\n")
    docs = tselfindex.process_python_files(tmp_path)
    assert [d["url"] for d in docs] == ["a.py", "sub/b.py"]
    assert docs[0]["title"] == "a.py"
    assert docs == jselfindex.process_python_files(tmp_path)
    package = REPO / "rag_faiss_embedding_tpu_torch"
    assert tselfindex.process_python_files(package) == \
        jselfindex.process_python_files(package)


def test_pipeline_end_to_end(tmp_path, managers):
    site = tmp_path / "site"
    site.mkdir()
    (site / "doc.html").write_text(SITE_PAGE)
    hits = []
    for m, mod in zip(managers, (jpipeline, tpipeline)):
        n = mod.run_pipeline(base_dir=str(m.config.base_dir), html_root=str(site),
                             config=m.config, manager=m)
        assert n == 1
        hits.append(m.search_similar_documents("jax compiles programs", k=1))
        assert json.loads((m.config.data_dir / "documents.json").read_text())[0][
            "content"] == hits[-1][0]["content"]
    j, t = hits
    assert t and "compiles" in t[0]["content"].lower()
    _same_hits(t, j)


def test_ingest_json_with_validation(tmp_path, managers):
    p = tmp_path / "search-index.json"
    p.write_text(json.dumps(RAW))
    found = []
    for m, mod in zip(managers, (jingest, tingest)):
        n = mod.ingest_json(m, p, validate=True)
        assert n == 1 and m.db.get_document_count() == 1
        found.append(m.search_similar_documents("real content document", k=1))
    j, t = found
    assert t and t[0]["url"] == "https://example.com/good"
    _same_hits(t, j)


# ------------------------------------------------------------ entry points
def test_mains_run_on_the_cpu_when_asked(tmp_path, capsys, monkeypatch):
    """pipeline -> search -> ingest_json -> admin --drop -> selfindex, each
    through ``main([... "--device", "cpu"])`` on one base dir."""
    for key in [k for k in os.environ if k.startswith("RFE_")]:
        monkeypatch.delenv(key)
    site = tmp_path / "site"
    site.mkdir()
    (site / "doc.html").write_text(SITE_PAGE)
    (site / "other.html").write_text(
        "<html><body><article>SQLite keeps documents in one file on the host. "
        "Each row has an id and a url.</article></body></html>")
    base, cpu = str(tmp_path / "base"), ["--device", "cpu"]
    tpipeline.main(["--base-dir", base, "--html-root", str(site)] + cpu)
    entries = json.loads((tmp_path / "base" / "data" / "documents.json").read_text())
    assert [e["title"] for e in entries] == ["doc.html", "other.html"]
    capsys.readouterr()
    tsearch.main(["--base-dir", base, "--top-k", "2"] + cpu + [entries[1]["content"]])
    out = capsys.readouterr().out
    assert out.index("other.html") < out.index("doc.html")
    (tmp_path / "raw.json").write_text(json.dumps(RAW))
    tingest.main(["--base-dir", base, "--input", str(tmp_path / "raw.json")] + cpu)
    db = TDatabase(tmp_path / "base" / "data" / "documents.db")
    assert db.get_document_count() == 3
    db.close()
    tadmin.main(["--base-dir", base, "--drop"] + cpu)
    assert "dropped" in capsys.readouterr().out
    src = tmp_path / "src"
    src.mkdir()
    for i in range(4):
        (src / f"m{i}.py").write_text(f"def f{i}():\n    return {i} * {i + 1}\n")
    tselfindex.main(["--base-dir", base, "--source-dir", str(src)] + cpu)
    db = TDatabase(tmp_path / "base" / "data" / "documents.db")
    assert db.get_document_count() == 4
    db.close()


@pytest.mark.parametrize("mod,args", [
    (tpipeline, []), (tsearch, ["q"]), (tingest, []),
    (tadmin, ["--drop"]), (tselfindex, [])])
def test_mains_need_the_card_by_default(tmp_path, monkeypatch, mod, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--base-dir", str(tmp_path)] + args)
