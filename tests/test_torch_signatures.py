"""The port's public signatures against the JAX package's.

Every public function and class that a port module shares with its JAX twin
(the same module path and name) is compared: a function's parameters, a
class's public methods' parameters, and the class's public members (methods,
properties, dataclass fields). A call written for the JAX API must work on
the port, so every difference is a gap, except:

- the port's added ``device`` parameter (its entry points take the card or
  the CPU explicitly);
- ``parent`` and ``name``, the fields Flax adds to every ``nn.Module``
  (the port's modules are ``torch.nn.Module``s);

and the gaps listed in ``GAPS``, each with the ROADMAP Queue 1 item whose
tier closes it. The test fails when a new gap appears, and when a listed gap
has closed but is still listed. For the training modules, the public names
the port lacks altogether are listed in ``MODULE_GAPS`` the same way.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import pytest
import torch

import rag_faiss_embedding_tpu_torch as port

ALLOWED_EXTRA = {"device"}
FLAX_FIELDS = {"parent", "name"}

# "module:qualname": (parameters or members the port lacks, parameters the
# port adds beyond ALLOWED_EXTRA, the ROADMAP Queue 1 item that closes it)
GAPS = {}

# public names a port module lacks against its JAX twin: "module": (names,
# the ROADMAP Queue 1 item that closes it)
MODULE_GAPS = {}


def _shared_items():
    """(port module, JAX module, name) of every public function and class
    defined in a port module whose JAX twin defines the same name."""
    items = []
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        tname = info.name
        jname = "rag_faiss_embedding_tpu" + tname[len(port.__name__):]
        try:
            jmod = importlib.import_module(jname)
        except ModuleNotFoundError as e:
            if not jname.startswith(str(e.name)):
                raise
            continue  # a module of the port alone (the kernels' wrappers, _build)
        tmod = importlib.import_module(tname)
        for name, obj in sorted(vars(tmod).items()):
            if name.startswith("_") or getattr(obj, "__module__", None) != tname:
                continue
            if (inspect.isfunction(obj) or inspect.isclass(obj)) and hasattr(jmod, name):
                items.append((tname[len(port.__name__) + 1:], name))
    return items


ITEMS = _shared_items()


def _params(fn):
    return list(inspect.signature(fn).parameters)


def _members(cls):
    """Public methods, properties and dataclass fields a class defines."""
    out = {n for n, v in vars(cls).items() if not n.startswith("_") and (
        inspect.isfunction(v) or isinstance(v, (classmethod, staticmethod, property)))}
    if dataclasses.is_dataclass(cls):
        out |= {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}
    return out


def _func(obj):
    return obj.__func__ if isinstance(obj, (classmethod, staticmethod)) else obj


def _diff(tfn, jfn, ignore=()):
    """(missing, extra) parameters of the port's function against JAX's; a
    shared parameter out of JAX's order counts as missing."""
    tp, jp = _params(tfn), _params(jfn)
    missing = {p for p in jp if p not in tp and p not in ignore}
    extra = {p for p in tp if p not in jp and p not in ALLOWED_EXTRA}
    shared_t = [p for p in tp if p in jp]
    shared_j = [p for p in jp if p in tp]
    missing |= {a for a, b in zip(shared_t, shared_j) if a != b}
    return missing, extra


def gaps_of(module: str, name: str) -> dict:
    """Every gap of one shared public name, keyed as in ``GAPS``."""
    tobj = getattr(importlib.import_module(f"{port.__name__}.{module}"), name)
    jobj = getattr(importlib.import_module(f"rag_faiss_embedding_tpu.{module}"), name)
    key = f"{module}:{name}"
    found = {}
    if inspect.isfunction(tobj):
        found[key] = _diff(tobj, jobj)
    else:
        flax = any(c.__module__.startswith("flax") for c in inspect.getmro(jobj))
        ignore = FLAX_FIELDS if flax else ()
        init = _params(tobj.__init__)  # a JAX dataclass field may be an argument here
        found[key] = ({m for m in _members(jobj) - FLAX_FIELDS
                       if not hasattr(tobj, m) and m not in init}, set())
        for meth in ["__init__"] + sorted(_members(jobj)):
            jm, tm = vars(jobj).get(meth), inspect.getattr_static(tobj, meth, None)
            if not (callable(_func(jm)) and callable(_func(tm))) or isinstance(jm, property):
                continue
            if meth == "__init__" and (flax or dataclasses.is_dataclass(jobj)):
                continue  # fields, compared as members
            found[f"{key}.{meth}"] = _diff(_func(tm), _func(jm), ignore)
    return {k: v for k, v in found.items() if v[0] or v[1]}


@pytest.mark.parametrize("module,name", ITEMS, ids=[f"{m}:{n}" for m, n in ITEMS])
def test_signature_matches_jax_but_for_listed_gaps(module, name):
    listed = {k: v[:2] for k, v in GAPS.items()
              if k == f"{module}:{name}" or k.startswith(f"{module}:{name}.")}
    assert gaps_of(module, name) == listed


def test_every_listed_gap_names_a_shared_item_and_a_tier():
    keys = {f"{m}:{n}" for m, n in ITEMS}
    for key, (_, _, tier) in GAPS.items():
        assert key in keys or key.rsplit(".", 1)[0] in keys, key
        assert tier.startswith("Queue 1 item "), key


# the serving, CLI, ingest and training modules (Queue 1 items 5 and 8),
# each public name compared
SERVING_AND_CLIS = {
    "cli.train": {"make_pairs", "batch_iterator", "train", "main"},
    "parallel.train": {"TrainState", "info_nce_loss", "train_step_fn", "make_train_step"},
    "parallel.checkpoint": {"TrainCheckpointer"},
    "serve.api": {"SearchService", "make_app", "main"},
    "serve.client": {"APISearch", "main"},
    "cli.admin": {"AdminTool", "main"},
    "cli.ingest_json": {"ingest_json", "main"},
    "cli.pipeline": {"run_pipeline", "main"},
    "cli.search": {"CLISearch", "main"},
    "cli.selfindex": {"process_python_files", "main"},
    "ingest.html": {"HtmlIngestor", "IndexEntry", "clean_text"},
    "ingest.validator": {"DocumentValidator", "main"},
    "utils.timers": {"StageTimer"},
    "utils.profiling": {"device_trace", "annotate"},
}


def test_serving_cli_and_ingest_modules_are_compared():
    compared = set(ITEMS)
    for module, names in SERVING_AND_CLIS.items():
        assert {(module, n) for n in names} <= compared, module


def _public_defs(mod):
    return {n for n, o in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(o) or inspect.isclass(o))
            and getattr(o, "__module__", None) == mod.__name__}


@pytest.mark.parametrize("module", sorted({m for m in SERVING_AND_CLIS if m.startswith(
    ("cli.train", "parallel."))}))
def test_training_modules_lack_only_listed_names(module):
    """Every public function and class of the JAX training modules is in the
    port, but the names ``MODULE_GAPS`` lists, each with its tier."""
    jmod = importlib.import_module(f"rag_faiss_embedding_tpu.{module}")
    tmod = importlib.import_module(f"{port.__name__}.{module}")
    missing = {n for n in _public_defs(jmod) if not hasattr(tmod, n)}
    listed, tier = MODULE_GAPS.get(module, (set(), "Queue 1 item "))
    assert missing == listed and tier.startswith("Queue 1 item ")


def test_closed_gaps_stay_closed():
    """The gaps closed so far: ``interpret`` on ``pq_search`` (the port has
    no interpret mode: True runs the plain decode) and ``use_pallas`` on
    ``FlatIndex`` (accepted for the JAX API; the card runs the kernel for
    every search); then the int8 tier's ``selector`` / ``recall_target`` of
    ``exact_search`` and ``pq_search`` and ``recall_target`` /
    ``rerank_shadow`` of ``FlatIndex``, ``VectorStore.import_faiss`` and
    ``MiniLMConfig.compute_dtype``; then ``IVFFlatIndex.build_chunked`` and
    ``MiniLMEncoder.init_params``; then ``VectorStore.__init__``'s ``mesh``
    with the sharded modules."""
    from rag_faiss_embedding_tpu_torch.index.flat import FlatIndex
    from rag_faiss_embedding_tpu_torch.index.vector_store import VectorStore
    from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMConfig
    from rag_faiss_embedding_tpu_torch.ops.distance import exact_search
    from rag_faiss_embedding_tpu_torch.ops.pq import pq_search

    assert "interpret" in _params(pq_search)
    assert "use_pallas" in _params(FlatIndex.__init__)
    for fn in (exact_search, pq_search):
        assert {"selector", "recall_target"} <= set(_params(fn))
    assert {"recall_target", "rerank_shadow"} <= set(_params(FlatIndex.__init__))
    assert callable(VectorStore.import_faiss)
    assert MiniLMConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    from rag_faiss_embedding_tpu_torch.index.ivf import IVFFlatIndex
    from rag_faiss_embedding_tpu_torch.models.minilm import MiniLMEncoder

    assert _params(IVFFlatIndex.build_chunked) == ["self", "source", "n", "chunk_size",
                                                   "train_rows"]
    assert _params(MiniLMEncoder.init_params) == ["self", "rng", "max_len"]
    # sharded search: the store's mesh and the mesh module's names
    assert _params(VectorStore.__init__)[-2:] == ["mesh", "device"]
    assert {("core.mesh", "make_mesh"), ("parallel.sharded", "ShardedFlatIndex"),
            ("parallel.sharded_ivf", "ShardedIVFIndex")} <= set(ITEMS)
    assert len(ITEMS) > 20
