"""Central configuration.

A copy of ``rag_faiss_embedding_tpu/core/config.py``: the same fields,
defaults, ``RFE_*`` overrides and validation, so one ``.env`` configures
either package.

Capability parity with the reference ``config.py:9-88`` (model name, batch
size, vector dimension, index metric L2|IP, top-k, paths, log format,
validation-on-construction) — but as an immutable dataclass with env/.env
overrides instead of a mutable class-attribute singleton, and with the
``L2``/``IP`` metric knob actually honored by the index layer (the reference
declares it at ``config.py:30`` but hardcodes ``IndexFlatL2`` in both stacks:
``faiss_store.py:29``, ``rag_datastore_manager.py:138``).

Env overrides use the ``RFE_`` prefix, e.g. ``RFE_BATCH_SIZE=64``.
A ``.env`` file in the working directory is parsed with a minimal built-in
reader (the reference uses python-dotenv, ``config.py:4-7``).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional

_ENV_PREFIX = "RFE_"


def _load_dotenv(path: Path) -> dict:
    """Minimal .env parser: KEY=VALUE lines, '#' comments, optional quotes."""
    out = {}
    if not path.is_file():
        return out
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        val = val.strip().strip("'\"")
        out[key.strip()] = val
    return out


@dataclasses.dataclass(frozen=True)
class Config:
    # Paths (reference config.py:11-18)
    base_dir: Path = Path.cwd()
    data_dir: Path = None  # type: ignore[assignment]
    logs_dir: Path = None  # type: ignore[assignment]

    # Model (reference config.py:25-27)
    model_name: str = "sentence-transformers/all-MiniLM-L6-v2"
    batch_size: int = 32
    vector_dimension: int = 384
    max_seq_length: int = 512
    pooling: str = "cls"  # "cls" (reference vectorization.py:44) or "mean"

    # Index (reference config.py:29-31)
    index_metric: str = "L2"  # "L2" or "IP" — honored for real here
    index_path: Path = None  # type: ignore[assignment]
    index_dtype: str = "float32"  # "float32" (FAISS-exact), "bfloat16", "int8"
    # "auto" resolves per dtype: int8 -> "rerank" (the only int8 flat config
    # that passes the 0.99 recall gate — the quantized cross term caps plain
    # int8+approx at ~0.980, docs/PERF.md), else "exact". Explicit values:
    # "exact" (top_k), "approx" (approx_max_k), "rerank" (int8 + bf16-shadow
    # exact rerank).
    search_selector: str = "auto"
    index_kind: str = "flat"  # "flat" (exact), "ivf" (ANN), "pq" (memory)
    ivf_nlist: int = 1024
    ivf_nprobe: int = 8
    ivf_balance: str = "spill"  # "spill" (exact overflow tier) or "reassign"
    ivf_pq_m: int = 0  # >0: IVF-PQ residual codes, M bytes/row (memory tier)
    #                             (capacity-capped lists, smaller windows)

    # Search (reference config.py:33-34)
    top_k: int = 5

    # Generation (reference query.py:15-17,71,95)
    generator_model: str = "google/flan-t5-base"
    generation_max_length: int = 200
    context_token_budget: int = 400

    # Data files (reference config.py:36-37)
    documents_json: Path = None  # type: ignore[assignment]
    search_index_json: Path = None  # type: ignore[assignment]
    db_path: Path = None  # type: ignore[assignment]

    # Serving
    api_host: str = "0.0.0.0"
    api_port: int = 8000
    serve_max_batch: int = 64
    serve_batch_timeout_ms: float = 2.0
    serve_watchdog_interval_s: float = 30.0  # 0 disables the self-probe

    # Logging (reference config.py:39-42)
    log_file: Optional[Path] = None
    log_level: str = "INFO"

    def __post_init__(self):
        base = Path(self.base_dir)
        object.__setattr__(self, "base_dir", base)
        defaults = {
            "data_dir": base / "data",
            "logs_dir": base / "logs",
        }
        for name, val in defaults.items():
            if getattr(self, name) is None:
                object.__setattr__(self, name, val)
        data = self.data_dir
        file_defaults = {
            "index_path": data / "index.tpu",
            "documents_json": data / "documents.json",
            "search_index_json": data / "search-index.json",
            "db_path": data / "documents.db",
        }
        for name, val in file_defaults.items():
            if getattr(self, name) is None:
                object.__setattr__(self, name, Path(val))
        if self.search_selector == "auto":
            object.__setattr__(
                self, "search_selector",
                "rerank" if self.index_dtype == "int8" else "exact",
            )
        self.validate()

    def validate(self) -> bool:
        """Reference config.py:57-79 validation, same rules."""
        if not self.model_name:
            raise ValueError("model_name must be specified")
        if self.vector_dimension <= 0:
            raise ValueError("vector_dimension must be positive")
        if self.index_metric not in ("L2", "IP"):
            raise ValueError("index_metric must be either 'L2' or 'IP'")
        if self.index_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                "index_dtype must be 'float32', 'bfloat16' or 'int8'"
            )
        if self.search_selector not in ("exact", "approx", "rerank"):
            raise ValueError(
                "search_selector must be 'exact', 'approx' or 'rerank'"
            )
        if self.search_selector == "rerank" and self.index_dtype != "int8":
            raise ValueError(
                "search_selector='rerank' requires index_dtype='int8' "
                "(the bf16-shadow rerank re-scores quantized candidates)"
            )
        if self.index_kind not in ("flat", "ivf", "pq"):
            raise ValueError("index_kind must be 'flat', 'ivf' or 'pq'")
        if self.ivf_nlist <= 0 or self.ivf_nprobe <= 0:
            raise ValueError("ivf_nlist and ivf_nprobe must be positive")
        if self.ivf_balance not in ("spill", "reassign"):
            raise ValueError("ivf_balance must be 'spill' or 'reassign'")
        if self.ivf_pq_m < 0:
            raise ValueError("ivf_pq_m must be >= 0 (0 = dense storage)")
        if self.ivf_pq_m and self.vector_dimension % self.ivf_pq_m:
            raise ValueError("vector_dimension must be divisible by ivf_pq_m")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.top_k <= 0:
            raise ValueError("top_k must be positive")
        if self.pooling not in ("cls", "mean"):
            raise ValueError("pooling must be 'cls' or 'mean'")
        return True

    def setup_directories(self) -> None:
        """Create data/log dirs (reference config.py:44-49)."""
        for d in (self.data_dir, self.logs_dir):
            Path(d).mkdir(parents=True, exist_ok=True)

    @classmethod
    def from_env(cls, base_dir: Optional[Path] = None, **overrides) -> "Config":
        """Build a config from defaults <- .env file <- process env <- kwargs."""
        base = Path(base_dir) if base_dir else Path.cwd()
        env = dict(_load_dotenv(base / ".env"))
        env.update({k: v for k, v in os.environ.items() if k.startswith(_ENV_PREFIX)})
        kwargs = {"base_dir": base}
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for key, raw in env.items():
            name = key[len(_ENV_PREFIX):].lower() if key.startswith(_ENV_PREFIX) else key.lower()
            f = fields.get(name)
            if f is None or name in overrides:
                continue
            kwargs[name] = _coerce(raw, f.type)
        kwargs.update(overrides)
        return cls(**kwargs)


def _coerce(raw: str, annot) -> object:
    s = str(annot)
    if "int" in s:
        return int(raw)
    if "float" in s:
        return float(raw)
    if "bool" in s:
        return raw.lower() in ("1", "true", "yes", "on")
    if "Path" in s:
        return Path(raw)
    return raw


_GLOBAL: Optional[Config] = None


def get_config() -> Config:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Config.from_env()
    return _GLOBAL


def set_config(cfg: Config) -> None:
    global _GLOBAL
    _GLOBAL = cfg
