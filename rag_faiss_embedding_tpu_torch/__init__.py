"""PyTorch / CUDA port of the retrieval / RAG framework, for one NVIDIA H100.

A second package beside ``rag_faiss_embedding_tpu`` (the JAX reference, which
stays as it is). Module names and public APIs follow the JAX package, so each
module here has its counterpart there:

  ops/       plain torch distance + top-k (``distance``), k-means
             (``kmeans``), product quantization (``pq``), int8 row
             quantization (``quantize``), the fused IVF search
             (``ivf_scan``) and the kernel wrappers (``flat_scan``,
             ``union_scan``, ``pq_decode``; CUDA sources in ``csrc/``)
  index/     FlatIndex, IVFFlatIndex (dense and IVF-PQ), PQIndex,
             VectorStore, the npz codec
  models/    MiniLM ``nn.Module``, Flax-param conversion, tokenizer,
             embedding pipeline, answer generator
  rag/       QueryEngine, RAGManager

Host modules that import no JAX are shared with the reference package
(``core.config``, ``core.logging``, ``store.database``, ``utils``, ``native``).
The reference's top-level ``__init__`` would configure JAX's compile cache on
import, so the guard below is set before anything from it is imported.
"""

import os as _os

_os.environ.setdefault("RFE_NO_COMPILE_CACHE", "1")
_os.environ.setdefault("HF_HUB_OFFLINE", "1")
_os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import torch as _torch

# float32 means float32 on the card: JAX runs f32 at Precision.HIGHEST.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# bf16 products accumulate in float32, as JAX's preferred_element_type asks
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"


def default_device() -> _torch.device:
    """``cuda`` when a card is present, else ``cpu``."""
    return _torch.device("cuda" if _torch.cuda.is_available() else "cpu")
