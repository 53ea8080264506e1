"""The port's FAISS flat importer (``index/faiss_import``) vs the JAX package's.

The JAX tests (``tests/test_faiss_import.py``) read the bundled reference
artifact and skip where it is not mounted; these synthesize
``faiss.write_index``-layout files from seeded vectors instead and give the
same files to both packages' readers and stores. Tolerances: the vectors,
ids and metrics read are identical; searches of the imported stores give
the same ids and distances to rtol 1e-5 / atol 1e-4.
"""

import pickle
import struct

import numpy as np
import pytest

from rag_faiss_embedding_tpu.index import VectorStore as JStore
from rag_faiss_embedding_tpu.index import faiss_import as JF
from rag_faiss_embedding_tpu_torch.index import VectorStore as TStore
from rag_faiss_embedding_tpu_torch.index import faiss_import as TF
from rag_faiss_embedding_tpu_torch.index import import_faiss_index

RTOL, ATOL = 1e-5, 1e-4


def _write_flat(path, vecs, fourcc=b"IxF2", metric_enum=1, count=None, trained=1,
                metric_arg=False):
    """A ``faiss.write_index``-layout flat file; ``count`` defaults to the
    legacy float count."""
    n, d = vecs.shape
    hdr = fourcc + struct.pack("<iqqqBi", d, n, 1 << 20, 1 << 20, trained, metric_enum)
    if metric_arg:
        hdr += struct.pack("<f", 0.0)
    count = n * d if count is None else count
    path.write_bytes(hdr + struct.pack("<Q", count) + vecs.astype("<f4").tobytes())


@pytest.mark.parametrize("fourcc,enum,metric", [
    (b"IxF2", 1, "L2"), (b"IxFI", 0, "IP"), (b"IxFl", 1, "L2"), (b"IxFl", 0, "IP"),
])
@pytest.mark.parametrize("convention", ["floats", "bytes"])
def test_reader_matches_jax(rng, tmp_path, fourcc, enum, metric, convention):
    vecs = rng.standard_normal((23, 16)).astype(np.float32)
    count = 23 * 16 * (4 if convention == "bytes" else 1)
    _write_flat(tmp_path / "f.bin", vecs, fourcc, enum, count)
    tv, tm = TF.read_flat_index(tmp_path / "f.bin")
    jv, jm = JF.read_flat_index(tmp_path / "f.bin")
    assert tm == jm == metric and tv.dtype == np.float32
    np.testing.assert_array_equal(tv, vecs)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("case", ["fourcc", "short", "count", "untrained", "metric"])
def test_bad_files_raise_like_jax(rng, tmp_path, case):
    vecs = rng.standard_normal((4, 8)).astype(np.float32)
    p = tmp_path / "bad.bin"
    if case == "fourcc":
        _write_flat(p, vecs, fourcc=b"IwFl")  # an IVF file
    elif case == "short":
        p.write_bytes(b"IxF2" + b"\0" * 10)
    elif case == "count":
        _write_flat(p, vecs, count=7)
    elif case == "untrained":
        _write_flat(p, vecs, trained=0)
    else:  # a metric the flat family does not take, with its metric_arg
        _write_flat(p, vecs, fourcc=b"IxFl", metric_enum=3, metric_arg=True)
    for mod in (TF, JF):
        with pytest.raises(mod.FaissImportError):
            mod.read_flat_index(p)


def test_mapping_sidecar_and_restricted_unpickler(tmp_path):
    ids = [5, 3, 9, 1]
    (tmp_path / "m.pkl").write_bytes(pickle.dumps(ids))
    assert TF.read_mapping(tmp_path / "m.pkl") == JF.read_mapping(tmp_path / "m.pkl") == ids
    # a pickled class is refused before anything of it runs
    (tmp_path / "evil.pkl").write_bytes(pickle.dumps([1, TF.FaissImportError("x")]))
    with pytest.raises(pickle.UnpicklingError, match="only plain"):
        TF.read_mapping(tmp_path / "evil.pkl")
    (tmp_path / "dict.pkl").write_bytes(pickle.dumps({"a": 1}))
    with pytest.raises(TF.FaissImportError, match="not a list of ints"):
        TF.read_mapping(tmp_path / "dict.pkl")


def test_import_faiss_index_ids_and_fallback(rng, tmp_path):
    vecs = rng.standard_normal((6, 8)).astype(np.float32)
    path = tmp_path / "faiss_index.bin"
    _write_flat(path, vecs)
    # no sidecar: sequential ids, as the reference loader falls back
    tv, tids, tm = import_faiss_index(path)
    assert tids == JF.import_faiss_index(path)[1] == list(range(6)) and tm == "L2"
    (tmp_path / "faiss_index.bin.mapping").write_bytes(pickle.dumps([40, 41, 42, 43, 44, 45]))
    assert import_faiss_index(path)[1] == [40, 41, 42, 43, 44, 45]
    (tmp_path / "other.mapping").write_bytes(pickle.dumps([1, 2]))
    with pytest.raises(TF.FaissImportError, match="2 ids for 6 vectors"):
        import_faiss_index(path, tmp_path / "other.mapping")


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_vector_store_import_matches_jax(rng, tmp_path, metric, dtype):
    """Both stores import the same file and sidecar: same doc ids, and
    searches (each vector's nearest is itself, mapped to its doc id) give
    the same ids and distances; the imported store saves in the port's own
    format and reloads. A metric or width the store does not have raises."""
    vecs = rng.standard_normal((23, 16)).astype(np.float32)
    fourcc, enum = (b"IxF2", 1) if metric == "L2" else (b"IxFI", 0)
    path = tmp_path / "faiss_index.bin"
    _write_flat(path, vecs, fourcc, enum, count=23 * 16 * 4)
    doc_ids = [int(i) for i in rng.permutation(np.arange(100, 123))]
    (tmp_path / "faiss_index.bin.mapping").write_bytes(pickle.dumps(doc_ids))
    tstore = TStore(dimension=16, metric=metric, dtype=dtype,
                    index_path=tmp_path / "t.tpu", device="cpu")
    jstore = JStore(dimension=16, metric=metric, dtype=dtype, index_path=tmp_path / "j.tpu")
    jstore.index._use_pallas = False
    assert tstore.import_faiss(path) == jstore.import_faiss(path) == 23
    assert tstore.doc_ids == jstore.doc_ids == doc_ids
    (td, ti), (jd, ji) = tstore.search(vecs, k=3), jstore.search(vecs, k=3)
    assert ti == ji
    if metric == "L2":
        assert [row[0] for row in ti] == doc_ids
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    tstore.save_index()
    again = TStore(dimension=16, metric=metric, index_path=tmp_path / "t.tpu", device="cpu")
    assert again.doc_ids == doc_ids and again.search(vecs, k=3)[1] == ti
    other = "IP" if metric == "L2" else "L2"
    with pytest.raises(ValueError, match="FAISS file is"):
        TStore(dimension=16, metric=other, index_path=tmp_path / "x.tpu",
               device="cpu").import_faiss(path)
    with pytest.raises(ValueError, match="-d but this store"):
        TStore(dimension=8, metric=metric, index_path=tmp_path / "y.tpu",
               device="cpu").import_faiss(path)
