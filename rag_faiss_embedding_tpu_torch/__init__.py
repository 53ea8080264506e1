"""PyTorch / CUDA port of the retrieval / RAG framework, for one NVIDIA H100.

A second package beside ``rag_faiss_embedding_tpu`` (the JAX reference, which
stays as it is). Module names and public APIs follow the JAX package, so each
module here has its counterpart there:

  ops/       plain torch distance + top-k (``distance``), k-means
             (``kmeans``), product quantization (``pq``), int8 row
             quantization (``quantize``), the fused IVF search
             (``ivf_scan``) and the kernel wrappers (``flat_scan``,
             ``union_scan``, ``pq_decode``, ``fused_proto``,
             ``kernel_probe``; CUDA sources in ``csrc/``)
  index/     FlatIndex, IVFFlatIndex (dense and IVF-PQ), PQIndex,
             VectorStore, the npz codec
  models/    MiniLM ``nn.Module``, Flax-param conversion, tokenizer,
             embedding pipeline, answer generator
  rag/       QueryEngine, RAGManager
  parallel/  sharded search over a device mesh (``sharded``,
             ``sharded_ivf``), training on one card or a mesh
             (``train``, ``checkpoint``)
  serve/, cli/, ingest/
             the HTTP server and its client, the command lines, HTML
             ingestion
  benchmarks/  the prototype and probe scripts of the fused union scan
             (``fused_proto``, ``kernel_probe``)
  core/, store/, utils/, native/
             the device mesh (``core/mesh``), and copies of the JAX
             package's host modules (config, logging, the SQLite store,
             text utilities, the C++ WordPiece tokenizer)

The package imports nothing of the JAX package: it carries its own copies of
the host modules it needs.
"""

import os as _os

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
    """``cuda``, the device an entry point uses when it is given none.

    Raises ``RuntimeError`` where no card is visible: a machine that has lost
    its card must not serve from the CPU unnoticed, so running on the CPU
    takes an explicit ``device="cpu"``."""
    if not _torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is visible; pass device="cpu" to run on the CPU')
    return _torch.device("cuda")
