"""The inputs a configuration names, and the program built over them.

``Inputs`` is the benchmark's: the vocabulary, the encoder's weights, the
documents and the vectors, all made from the seed (``data.py``). The plain
reference and the controls read only these.

``Program`` is the system under test, ``rag_faiss_embedding_tpu_torch``,
built through its public constructors from the same inputs: the tokenizer,
the ``EmbeddingPipeline``, the SQLite ``Database`` (through the
``RAGManager``), the index the configuration names inside a ``VectorStore``,
the ``QueryEngine`` and the ``RAGManager``. Each part is built on first
use, so a cell builds only what its traffic drives.
"""

from __future__ import annotations

import functools
import gc
import importlib
import time
from functools import cached_property
from pathlib import Path

import numpy as np
import torch

from . import data, work

PACKAGE = "rag_faiss_embedding_tpu_torch"


def built(fn):
    """A cached property that records the seconds its first build took (the
    builds it starts included) in the instance's ``timings``."""
    @functools.wraps(fn)
    def get(self):
        t = time.monotonic()
        value = fn(self)
        self.timings[fn.__name__] = time.monotonic() - t
        return value

    return cached_property(get)


class Inputs:
    def __init__(self, config: dict, seed: int, devices: list):
        self.config, self.seed, self.devices = config, seed, devices
        self.model = config["model"]
        self.timings = {}

    @property
    def device(self):
        return self.devices[0]

    @built
    def vocab(self) -> data.Vocabulary:
        return data.vocabulary(self.seed)

    @built
    def weights(self) -> dict:
        return data.minilm_weights(self.model, self.seed, self.device)

    @built
    def corpus(self) -> data.Corpus:
        c = self.config["corpus"]
        return data.corpus(self.vocab, self.seed, c["documents"], tuple(c["words"]))

    @cached_property
    def centres(self):
        r = self.config["rows"]
        return data.centres(self.seed, r["modes"], r["dim"], self.device)

    @property
    def n_rows(self) -> int:
        return self.config["rows"]["n"]

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def shard(self, j: int):
        """Rows of shard ``j`` (one per device), on its device."""
        per = self.n_rows // self.n_shards
        return data.shard_rows(self.seed, j, per, self.centres, self.devices[j])

    def rows_of(self, ids: torch.Tensor) -> torch.Tensor:
        """Rows of global ids, made again shard by shard."""
        per = self.n_rows // self.n_shards
        out = torch.empty(len(ids), self.config["rows"]["dim"], device=self.device)
        for j in range(self.n_shards):
            sel = ((ids // per) == j).nonzero().flatten()
            if len(sel):
                out[sel] = self.shard(j)[(ids[sel] % per).to(self.devices[j])].to(self.device)
        return out

    def queries(self, n: int, tag: int):
        return data.query_rows(self.seed, self.rows_of, self.n_rows, n, self.device, tag)


def _program_state_dict(w: dict, n_layers: int) -> dict:
    """The benchmark's weight names -> the program's ``MiniLMEncoder`` keys."""
    sd = {"embeddings.word_embeddings.weight": w["word"],
          "embeddings.position_embeddings.weight": w["position"],
          "embeddings.token_type_embeddings.weight": w["token_type"],
          "embeddings.layer_norm.weight": w["emb_ln.w"],
          "embeddings.layer_norm.bias": w["emb_ln.b"]}
    names = {"q": "attention.query", "k": "attention.key", "v": "attention.value",
             "o": "attention.output", "ff1": "intermediate", "ff2": "ffn_output",
             "ln1": "attention_norm", "ln2": "ffn_norm"}
    for i in range(n_layers):
        for ours, theirs in names.items():
            sd[f"layers.{i}.{theirs}.weight"] = w[f"{i}.{ours}.w"]
            sd[f"layers.{i}.{theirs}.bias"] = w[f"{i}.{ours}.b"]
    return sd


class Program:
    def __init__(self, inputs: Inputs, workdir: Path):
        self.inputs, self.config, self.workdir = inputs, inputs.config, Path(workdir)
        self.timings = inputs.timings
        self.workdir.mkdir(parents=True, exist_ok=True)

    def _mod(self, name: str):
        return importlib.import_module(f"{PACKAGE}.{name}")

    @property
    def device(self):
        return self.inputs.device

    @cached_property
    def port_config(self):
        Config = self._mod("core.config").Config
        return Config(base_dir=self.workdir, **self.config.get("port", {}))

    @built
    def tokenizer(self):
        tok = self._mod("models.tokenizer").WordPieceTokenizer(
            {t: i for i, t in enumerate(self.inputs.vocab.tokens)})
        tok.enable_native()
        return tok

    @built
    def embedder(self):
        minilm = self._mod("models.minilm")
        m = self.inputs.model
        cfg = minilm.MiniLMConfig(
            vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
            num_layers=m["num_hidden_layers"], num_heads=m["num_attention_heads"],
            intermediate_size=m["intermediate_size"],
            max_position_embeddings=m["max_position_embeddings"],
            type_vocab_size=m["type_vocab_size"], layer_norm_eps=m["layer_norm_eps"],
            dtype=self.config["encoder"]["dtype"])
        pc = self.port_config
        pipe = self._mod("models.encoder").EmbeddingPipeline(
            cfg=cfg, params=self._mod("models.convert").deterministic_params(cfg),
            tokenizer=self.tokenizer, pooling=pc.pooling, max_seq_length=pc.max_seq_length,
            normalize=pc.index_metric == "IP", device=self.device)
        pipe.model.load_state_dict(_program_state_dict(self.inputs.weights, cfg.num_layers))
        return pipe

    @built
    def manager(self):
        """The ``RAGManager`` over this embedder; its store is replaced by
        ``store`` and its database holds the corpus."""
        mgr = self._mod("rag.manager").RAGManager(
            config=self.port_config, embedder=self.embedder, device=self.device)
        mgr.vector_store = self.store
        return mgr

    @built
    def db(self):
        """The manager's SQLite store, filled with the corpus in one call."""
        db = self.manager.db
        ids = db.insert_documents(self.inputs.corpus.documents())
        if ids[0] != 1 or ids[-1] != len(ids):
            raise RuntimeError("the corpus did not get ids 1..n")
        return db

    @built
    def index(self):
        spec = dict(self.config["index"])
        kind = spec.pop("kind")
        dim, n = self.config["rows"]["dim"], self.inputs.n_rows
        if kind == "flat":
            idx = self._mod("index.flat").FlatIndex(dim, capacity=n, device=self.device, **spec)
            idx.add(self.inputs.shard(0))
        elif kind == "ivf":
            idx = self._mod("index.ivf").IVFFlatIndex(dim, device=self.device, **spec)
            idx.build(self.inputs.shard(0))
        elif kind == "sharded_flat":
            mesh = self._mod("core.mesh").make_mesh(
                {"db": len(self.inputs.devices)}, devices=self.inputs.devices)
            idx = self._mod("parallel.sharded").ShardedFlatIndex(dim, mesh, capacity=n, **spec)
            for j in range(self.inputs.n_shards):  # each shard made on its own card
                idx.add(self.inputs.shard(j))
        else:
            raise ValueError(f"unknown index kind {kind!r}")
        self.sync()
        return idx

    @built
    def store(self):
        store = self._mod("index.vector_store").VectorStore(
            dimension=self.config["rows"]["dim"], metric=self.index.metric,
            index_path=self.workdir / "index.npz", index=self.index, device=self.device)
        store.doc_ids = list(range(1, self.inputs.n_rows + 1))  # row i -> document i + 1
        return store

    @built
    def engine(self):
        gen = self._mod("models.generator").AnswerGenerator(backend="extractive")
        return self._mod("rag.engine").QueryEngine(self.db, self.store, self.embedder,
                                                   generator=gen)

    def sync(self) -> None:
        for d in self.inputs.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # ------------------------------------------------------------ work
    def search_work(self, q: np.ndarray, k: int) -> list:
        """(dtype, work) of each kernel launch a search of queries ``q``
        needs: K1 once per shard over its rows, or K2 over the probed lists
        and the coarse product. IVF reads the index's centroids and list
        lengths to know which rows the search must read."""
        kind = self.config["index"]["kind"]
        nq, d = q.shape
        if kind in ("flat", "sharded_flat"):
            per = self.inputs.n_rows // self.inputs.n_shards
            return [("k1", work.flat_work(nq, per, d, k)) for _ in range(self.inputs.n_shards)]
        idx = self.index
        cents, lengths = getattr(idx, "centroids", None), getattr(idx, "_lengths", None)
        if cents is None or lengths is None:
            return []
        qt = torch.as_tensor(q, device=cents.device)
        dist = (qt * qt).sum(1, keepdim=True) - 2 * qt @ cents.t() + (cents * cents).sum(1)
        probe = torch.topk(dist, min(idx.nprobe, len(cents)), largest=False).indices
        live = lengths.to(cents.device).long()
        probed = int(live[probe].sum())
        union = int(live[torch.unique(probe)].sum())
        coarse = {"bytes": 0, "flops": 2 * nq * len(cents) * d, "dtype": idx.dtype_name}
        return [("k2", work.ivf_work(nq, d, k, probed, union, idx.dtype_name)),
                ("coarse", coarse)]

    def free(self) -> None:
        """Drop every part of the program, so the reference runs in the
        memory it leaves."""
        for name in ("engine", "manager", "store", "index", "db", "embedder", "tokenizer"):
            self.__dict__.pop(name, None)
        gc.collect()
        for d in self.inputs.devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()
