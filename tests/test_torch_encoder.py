"""MiniLM port (models/minilm, convert, tokenizer, encoder) vs the Flax package.

The JAX package's own seeded parameters are moved across with
``load_flax_params`` (or through ``encoder_params.npz``), and the same token
ids go through both encoders on the CPU. Tolerance: pooled float32
embeddings atol 1e-4 (f32 on both sides; sums and LayerNorm statistics are
taken in different orders). The tokenizer copy must give identical ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rag_faiss_embedding_tpu.models import EmbeddingPipeline as JPipe
from rag_faiss_embedding_tpu.models import MiniLMConfig as JConfig
from rag_faiss_embedding_tpu.models import MiniLMEncoder as JEncoder
from rag_faiss_embedding_tpu.models import convert as jconvert
from rag_faiss_embedding_tpu.models.tokenizer import WordPieceTokenizer as JTok
from rag_faiss_embedding_tpu_torch.models import EmbeddingPipeline as TPipe
from rag_faiss_embedding_tpu_torch.models import MiniLMConfig, MiniLMEncoder
from rag_faiss_embedding_tpu_torch.models import convert as tconvert
from rag_faiss_embedding_tpu_torch.models.tokenizer import WordPieceTokenizer as TTok

ATOL = 1e-4
WIDTHS = dict(vocab_size=2048, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=128)
SMALL = MiniLMConfig(**WIDTHS)
CORPUS = [
    "jax compiles numerical programs for tpus",
    "faiss performs similarity search over dense vectors",
    "sqlite is a small embedded relational database",
    "transformers encode sentences into embeddings, café naïve résumé",
] * 3


@pytest.fixture(scope="module")
def jax_params():
    return jconvert.deterministic_params(JConfig(**WIDTHS), seed=0)


@pytest.fixture(scope="module")
def torch_model(jax_params):
    model = MiniLMEncoder(SMALL)
    model.load_state_dict(tconvert.load_flax_params(jax_params))
    return model.eval()


def _ids(rng, b=3, t=12, pad=4):
    ids = rng.integers(5, WIDTHS["vocab_size"], size=(b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    if pad:  # the last row is padded
        mask[-1, t - pad:] = 0
        ids[-1, t - pad:] = 0
    return ids, mask


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_encoder_matches_flax(rng, jax_params, torch_model, pooling):
    ids, mask = _ids(rng)
    ref = JEncoder(JConfig(**WIDTHS)).apply(
        {"params": jax_params}, jnp.asarray(ids), jnp.asarray(mask),
        pooling=pooling)
    with torch.no_grad():
        out = torch_model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                          pooling=pooling)
    assert out.shape == (3, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_padding_invariance(rng, torch_model):
    ids, mask = _ids(rng, b=1, pad=0)
    ids_p = np.pad(ids, ((0, 0), (0, 20)))
    mask_p = np.pad(mask, ((0, 0), (0, 20)))
    with torch.no_grad():
        for pooling in ("cls", "mean"):
            short = torch_model(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask), pooling=pooling)
            long = torch_model(torch.from_numpy(ids_p).long(),
                               torch.from_numpy(mask_p), pooling=pooling)
            np.testing.assert_allclose(short.numpy(), long.numpy(), atol=2e-5)


def test_param_files_cross_load(tmp_path, jax_params):
    """encoder_params.npz from either package loads in the other, and the
    state dict converts back to the Flax layout losslessly."""
    jconvert.export_params(jax_params, tmp_path / "j.npz")
    tree = tconvert.import_params(tmp_path / "j.npz")
    assert tconvert.infer_config_from_params(tree) == SMALL
    sd = tconvert.load_flax_params(tree)
    back = tconvert.to_flax_params(sd, SMALL)
    tconvert.export_params(back, tmp_path / "t.npz")
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    jtree = jconvert.import_params(tmp_path / "t.npz")
    assert jconvert.infer_config_from_params(jtree) == JConfig(**WIDTHS)


def test_deterministic_params_shapes_match_flax(jax_params):
    ours = tconvert.deterministic_params(SMALL, seed=0)
    again = tconvert.deterministic_params(SMALL, seed=0)
    flat = lambda t, p="": (
        {k2: v2 for k, v in t.items() for k2, v2 in flat(v, f"{p}/{k}").items()}
        if isinstance(t, dict) else {p: np.asarray(t)})
    a, b, c = flat(ours), flat(jax_params), flat(again)
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    for key in a:
        np.testing.assert_array_equal(a[key], c[key])  # seeded: reproducible


def test_tokenizer_copy_matches_jax(tmp_path):
    jtok = JTok.train(CORPUS, vocab_size=200)
    jtok.save(tmp_path / "vocab.txt")
    ttok = TTok.from_vocab_file(tmp_path / "vocab.txt")
    assert ttok.vocab == jtok.vocab
    texts = CORPUS[:4] + ["unseen wordpieces: tpuification, résumé!"]
    for native in (False, True):
        if native:
            jtok.enable_native()
            ttok.enable_native()
        for text in texts:
            assert ttok.encode(text, 64) == jtok.encode(text, 64)
        ti, tm = ttok.encode_batch(texts, 64)
        ji, jm = jtok.encode_batch(texts, 64)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
    assert ttok.decode(ti[0]) == jtok.decode(ji[0])


def test_tokenizer_decode_matches_jax_on_any_ids():
    """The port's one-join decode against the JAX copy's token-by-token
    loop, on id runs that start with, repeat and mix ``##`` pieces, bare
    ``##``, an empty token, specials and ids past the vocabulary."""
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "", "##", "###", "####x",
            "a", "bc", "##d", "##ef", "g", "##h"]
    vocab = {t: i for i, t in enumerate(toks)}
    jtok, ttok = JTok(vocab), TTok(vocab)
    rng = np.random.default_rng(7)
    for n in range(48):
        for _ in range(8):
            ids = rng.integers(0, len(toks) + 3, size=n)
            assert ttok.decode(ids) == jtok.decode(ids)
            assert ttok.decode(ids.tolist()) == jtok.decode(ids.tolist())


@pytest.mark.parametrize("pooling,normalize", [("cls", False), ("mean", True)])
def test_pipeline_matches_jax_on_shared_files(tmp_path, jax_params, pooling,
                                              normalize):
    """Both pipelines, pointed at one vocab.txt and one encoder_params.npz,
    embed the same texts alike (a short last batch and sequence buckets
    included)."""
    JTok.train(CORPUS, vocab_size=200).save(tmp_path / "vocab.txt")
    jconvert.export_params(jax_params, tmp_path / "encoder_params.npz")
    kw = dict(model_name="offline-test", pooling=pooling, normalize=normalize,
              max_seq_length=64, vocab_path=tmp_path / "vocab.txt",
              params_path=tmp_path / "encoder_params.npz")
    jp, tp = JPipe(**kw), TPipe(device="cpu", **kw)
    assert tp.cfg == SMALL and tp.tokenizer.vocab == jp.tokenizer.vocab
    je = jp.generate_embeddings(CORPUS, batch_size=4)
    te = tp.generate_embeddings(CORPUS, batch_size=4)
    assert te.shape == (len(CORPUS), 32) and te.dtype == np.float32
    np.testing.assert_allclose(te, je, atol=ATOL)
    np.testing.assert_allclose(tp.embed_query(CORPUS[1]), je[1], atol=ATOL)


def _bf16_atol(ref) -> float:
    """Two bf16 ulps of the largest output value."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7 + 1)


def test_bf16_compute_is_not_ported(rng, jax_params, torch_model):
    """The bf16 compute mode is ported. Against the Flax bf16 encoder on the
    same params and ids, the pooled float32 output agrees within two bf16
    ulps of its largest value (measured: the same bits at these widths; at
    full MiniLM-L6 width up to two ulps, 0.031 of 3.4, where the float32 sums
    inside each bf16 product run in another order). Against the port's own
    float32 encoder: cosine > 0.99, JAX's bar (``tests/test_minilm.py``)."""
    cfg = MiniLMConfig(**WIDTHS, dtype="bfloat16")
    assert cfg.compute_dtype == torch.bfloat16 and SMALL.compute_dtype == torch.float32
    model = MiniLMEncoder(cfg)
    model.load_state_dict(tconvert.load_flax_params(jax_params))
    model.eval()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ids, mask = _ids(rng)
    for pooling in ("cls", "mean"):
        ref = np.asarray(JEncoder(JConfig(**WIDTHS, dtype="bfloat16")).apply(
            {"params": jax_params}, jnp.asarray(ids), jnp.asarray(mask), pooling=pooling))
        with torch.no_grad():
            args = (torch.from_numpy(ids).long(), torch.from_numpy(mask))
            out = model(*args, pooling=pooling)
            f32 = torch_model(*args, pooling=pooling).numpy()
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_bf16_atol(ref))
        cos = (out.numpy() * f32).sum(1) / (np.linalg.norm(out.numpy(), axis=1)
                                            * np.linalg.norm(f32, axis=1))
        assert cos.min() > 0.99


def test_bf16_pipeline_matches_flax_pipeline(tmp_path, jax_params):
    """``EmbeddingPipeline(cfg=MiniLMConfig(dtype="bfloat16"))`` against the
    JAX pipeline in bf16 on one vocab and one params file (two bf16 ulps, as
    above), and against the port's float32 pipeline by cosine > 0.99."""
    JTok.train(CORPUS, vocab_size=200).save(tmp_path / "vocab.txt")
    jconvert.export_params(jax_params, tmp_path / "encoder_params.npz")
    kw = dict(model_name="offline-test", max_seq_length=64,
              vocab_path=tmp_path / "vocab.txt", params_path=tmp_path / "encoder_params.npz")
    jp = JPipe(cfg=JConfig(**WIDTHS, dtype="bfloat16"), **kw)
    tp = TPipe(cfg=MiniLMConfig(**WIDTHS, dtype="bfloat16"), device="cpu", **kw)
    t32 = TPipe(device="cpu", **kw)
    je = jp.generate_embeddings(CORPUS, batch_size=4)
    te = tp.generate_embeddings(CORPUS, batch_size=4)
    e32 = t32.generate_embeddings(CORPUS, batch_size=4)
    assert te.dtype == np.float32 and te.shape == e32.shape
    np.testing.assert_allclose(te, je, rtol=0, atol=_bf16_atol(je))
    cos = (te * e32).sum(1) / (np.linalg.norm(te, axis=1) * np.linalg.norm(e32, axis=1))
    assert cos.min() > 0.99


def test_hf_bert_checkpoint_converts(rng):
    """A (random-init) HF ``BertModel`` converted by the port's
    ``convert_bert_state_dict`` gives the same CLS output as HF's own
    forward: the checkpoint path ``load_pretrained`` takes when a local HF
    cache exists."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.BertConfig(
        vocab_size=WIDTHS["vocab_size"], hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=128, hidden_act="gelu")
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg, add_pooling_layer=False).eval()
    ours = MiniLMEncoder(SMALL).eval()
    ours.load_state_dict(tconvert.load_flax_params(
        tconvert.convert_bert_state_dict(hf.state_dict(), SMALL)))
    ids, mask = _ids(rng)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.no_grad():
        ref = hf(input_ids=ids_t, attention_mask=mask_t).last_hidden_state[:, 0]
        out = ours(ids_t, mask_t)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)


# ---- length-ordered batches: a call is cut into batches longest text first
# (stable by character count) and comes back in input order.

WORDS = ["vector", "search", "tensor", "cores", "shard", "merge", "query", "index",
         "sqlite", "commit", "batch", "token", "encoder", "latency", "card", "host"]
LONG = MiniLMConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_position_embeddings=512)


@pytest.fixture(scope="module")
def long_pipe():
    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)}
    return TPipe(model_name="offline-test", cfg=LONG,
                 params=tconvert.deterministic_params(LONG, seed=3),
                 tokenizer=TTok(vocab), max_seq_length=512, device="cpu")


def _mixed(seed, n, lo=1, hi=300):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi + 1)))) for _ in range(n)]


def _spy(monkeypatch, tok):
    """Every batch ``encode_batch`` is given, with the positions it padded to."""
    seen, encode = [], tok.encode_batch

    def spy(texts, *a, **kw):
        ids, mask = encode(texts, *a, **kw)
        seen.append((list(texts), mask.size))
        return ids, mask

    monkeypatch.setattr(tok, "encode_batch", spy)
    return seen, encode


def _chunks(texts, size):
    return [texts[i:i + size] for i in range(0, len(texts), size)]


def test_length_ordered_batches_return_input_order(long_pipe):
    """Row for row in input order, what each text gives embedded alone;
    repeated texts come back identical."""
    texts = _mixed(0, 90)
    texts += texts[:10]
    texts = [texts[i] for i in np.random.default_rng(1).permutation(len(texts))]
    got = long_pipe.generate_embeddings(texts, batch_size=8)
    alone = np.stack([long_pipe.generate_embeddings([t], batch_size=1)[0] for t in texts])
    assert got.shape == (100, LONG.hidden_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, alone, rtol=1e-5, atol=2e-5)
    first = {}
    for i, t in enumerate(texts):
        np.testing.assert_array_equal(got[i], got[first.setdefault(t, i)])
    assert len(first) == 90


def test_length_ordered_batches_pad_less(long_pipe, monkeypatch):
    """A mixed-length call pads fewer positions than batches cut in arrival
    order; ``encoder.embed`` counts its rows under a recording span root."""
    from torch.profiler import ProfilerActivity, profile

    from rag_faiss_embedding_tpu_torch.utils import timers

    texts = _mixed(2, 64)
    seen, encode = _spy(monkeypatch, long_pipe.tokenizer)
    timers.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            long_pipe.generate_embeddings(texts, batch_size=8)
        [embed] = [r for r in timers.spans() if r["name"] == "encoder.embed"]
    finally:
        timers.clear()
    arrival = sum(encode(c, 512)[1].size for c in _chunks(texts, 8))
    assert [len(b) for b, _ in seen] == [8] * 8
    assert sorted(t for b, _ in seen for t in b) == sorted(texts)
    lengths = [len(t) for b, _ in seen for t in b]
    assert lengths == sorted(lengths, reverse=True)
    assert embed["counts"] == {"rows": 64}
    assert sum(n for _, n in seen) < arrival


@pytest.mark.parametrize("case", ["equal_lengths", "one_batch"])
def test_length_ordered_batches_keep_arrival_order(long_pipe, monkeypatch, case):
    """Texts of one length, and a call that fits in one batch, see the
    batches arrival order gives, in the same order."""
    if case == "equal_lengths":  # 5-letter words only: one character count
        five = [w for w in WORDS if len(w) == 5]
        rng = np.random.default_rng(4)
        texts, size = [" ".join(rng.choice(five, size=40)) for _ in range(20)], 8
        assert len({len(t) for t in texts}) == 1
    else:
        texts, size = _mixed(5, 8), 8
    seen, encode = _spy(monkeypatch, long_pipe.tokenizer)
    got = long_pipe.generate_embeddings(texts, batch_size=size)
    assert [b for b, _ in seen] == _chunks(texts, size)
    assert sum(n for _, n in seen) == sum(encode(c, 512)[1].size for c in _chunks(texts, size))
    np.testing.assert_array_equal(
        got, np.concatenate([long_pipe.generate_embeddings(c, batch_size=size)
                             for c in _chunks(texts, size)]))
