"""The port's entry points run on the card unless the caller asks for the CPU.

Without a visible card (simulated here, so the tests hold on any machine),
every entry point built without ``device=`` raises and names the way out,
``device="cpu"``; with ``device="cpu"`` it builds as before.
"""

import pytest
import torch

import rag_faiss_embedding_tpu_torch as pkg
from rag_faiss_embedding_tpu_torch.core.config import Config
from rag_faiss_embedding_tpu_torch.index import FlatIndex, IVFFlatIndex, PQIndex
from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline, MiniLMConfig
from rag_faiss_embedding_tpu_torch.rag import RAGManager

SMALL = MiniLMConfig(vocab_size=64, hidden_size=8, num_layers=1, num_heads=2,
                     intermediate_size=16, max_position_embeddings=32)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _entry_points(tmp_path):
    return {
        "FlatIndex": lambda **kw: FlatIndex(8, **kw),
        "IVFFlatIndex": lambda **kw: IVFFlatIndex(8, nlist=4, **kw),
        "PQIndex": lambda **kw: PQIndex(8, m=2, **kw),
        "EmbeddingPipeline": lambda **kw: EmbeddingPipeline(cfg=SMALL, **kw),
        "RAGManager": lambda **kw: RAGManager(Config(base_dir=tmp_path), **kw),
    }


@pytest.mark.parametrize("name", ["FlatIndex", "IVFFlatIndex", "PQIndex",
                                  "EmbeddingPipeline", "RAGManager"])
def test_no_card_and_no_device_raises(no_card, tmp_path, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points(tmp_path)[name]()


@pytest.mark.parametrize("name", ["FlatIndex", "IVFFlatIndex", "PQIndex",
                                  "EmbeddingPipeline"])
def test_no_card_with_cpu_device_builds(no_card, tmp_path, name):
    assert _entry_points(tmp_path)[name](device="cpu").device == torch.device("cpu")


def test_rag_manager_with_cpu_device_builds(no_card, tmp_path):
    emb = EmbeddingPipeline(cfg=SMALL, device="cpu")
    manager = RAGManager(Config(base_dir=tmp_path), embedder=emb, device="cpu")
    assert manager.device == torch.device("cpu")
    assert manager.vector_store.device == torch.device("cpu")


def test_default_device_is_cuda_where_a_card_is_visible(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pkg.default_device() == torch.device("cuda")
