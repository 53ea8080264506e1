"""The training CLI in the port (cli/train.py) vs the JAX package's.

``make_pairs`` and ``batch_iterator`` consume the numpy ``Generator`` as
JAX's do: one seed, the same pairs and token batches. ``train`` (TINY, the
config of tests/test_train_cli.py, 6 steps on the CPU) writes an
``encoder_params.npz`` and a vocabulary that both packages'
``EmbeddingPipeline`` load, embedding within 1e-4 of each other. The
WordPiece trainer is stubbed in both packages to return one vocabulary: the
HF trainer orders tied tokens differently from run to run. ``main`` runs
through ``--device cpu``.
"""

import json

import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.cli import train as jcli
from rag_faiss_embedding_tpu.models import EmbeddingPipeline as JPipe
from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer as JTok
from rag_faiss_embedding_tpu_torch.cli import train as tcli
from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline as TPipe
from rag_faiss_embedding_tpu_torch.models.convert import import_params
from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig
from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok

from .test_rag import DOCS

TINY = MiniLMConfig(vocab_size=512, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_position_embeddings=64, dropout_rate=0.0)


def corpus(seed=0, n=24):
    """DOCS plus documents long enough (>= 16 words) for the crop pairs."""
    rng = np.random.default_rng(seed)
    words = ("tensor core kernel index shard query vector cache encoder batch "
             "latency recall probe list centroid residual codebook").split()
    docs = list(DOCS)
    for i in range(n):
        body = " ".join(rng.choice(words, size=int(rng.integers(8, 60))))
        docs.append({"id": 100 + i, "url": f"https://ex/{i}", "title": f"doc{i}.html",
                     "content": f"{body}. {body[::-1]}"})
    return docs


@pytest.fixture(scope="module")
def vocab():
    """One vocabulary for both packages (the HF trainer is not run-to-run
    stable)."""
    return dict(JTok.train([d["content"] for d in corpus()], vocab_size=512).vocab)


def test_make_pairs_and_batches_equal_jax(vocab):
    docs = corpus()
    tp = tcli.make_pairs(docs, np.random.default_rng(7))
    jp = jcli.make_pairs(docs, np.random.default_rng(7))
    assert tp == jp and len(tp) > len(docs)
    tb = tcli.batch_iterator(tp, TTok(dict(vocab)), 8, 32, seed=3)
    jb = jcli.batch_iterator(jp, JTok(dict(vocab)), 8, 32, seed=3)
    for _ in range(3):
        t, j = next(tb), next(jb)
        assert t.keys() == j.keys()
        for k in t:
            assert isinstance(t[k], torch.Tensor) and t[k].shape == (8, 32)
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_train_exports_params_both_packages_load(tmp_path, vocab, monkeypatch):
    for cls in (TTok, JTok):
        monkeypatch.setattr(cls, "train", classmethod(lambda c, texts, **kw: c(dict(vocab))))
    docs = corpus()
    params, tokenizer = tcli.train(
        docs, cfg=TINY, steps=6, batch_size=8, max_len=32, learning_rate=1e-3,
        vocab_size=512, params_out=tmp_path / "encoder_params.npz",
        checkpoint_dir=tmp_path / "ckpt", device="cpu")
    assert tokenizer.vocab == vocab
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["6"]
    saved = import_params(tmp_path / "encoder_params.npz")
    np.testing.assert_array_equal(saved["layer_1"]["ffn_output"]["kernel"],
                                  params["layer_1"]["ffn_output"]["kernel"])
    tokenizer.save(tmp_path / "vocab.txt")
    kw = dict(model_name="trained", params_path=tmp_path / "encoder_params.npz",
              vocab_path=tmp_path / "vocab.txt", max_seq_length=32)
    tpipe, jpipe = TPipe(device="cpu", **kw), JPipe(**kw)
    assert tpipe.cfg.hidden_size == jpipe.cfg.hidden_size == 32
    texts = [d["content"] for d in docs]
    temb, jemb = tpipe.generate_embeddings(texts), jpipe.generate_embeddings(texts)
    assert temb.shape == (len(docs), 32)
    np.testing.assert_allclose(temb, np.asarray(jemb), rtol=0, atol=1e-4)
    sims = temb[:3] @ temb[:3].T
    assert np.argmax(sims[0]) == 0


def test_main_trains_through_device_cpu(tmp_path, vocab, monkeypatch):
    monkeypatch.setattr(TTok, "train", classmethod(lambda c, texts, **kw: c(dict(vocab))))
    doc_path = tmp_path / "docs.json"
    doc_path.write_text(json.dumps(corpus(n=6)))
    args = ["--base-dir", str(tmp_path), "--documents", str(doc_path), "--steps", "2",
            "--batch-size", "4", "--max-len", "16"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device"):
            tcli.main(args)  # the card is the default
    tcli.main(args + ["--device", "cpu"])
    data = tmp_path / "data"
    params = import_params(data / "encoder_params.npz")
    assert params["embeddings"]["word_embeddings"]["embedding"].shape == (
        max(len(vocab), 128), 384)  # full width, the trained vocabulary
    assert TTok.from_vocab_file(data / "vocab.txt").vocab == vocab
