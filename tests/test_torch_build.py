"""The kernel build key (``_build.build_key``) covers a source and the
headers it includes, so an edited header is rebuilt, not reused. Nothing
here compiles."""

from rag_faiss_embedding_tpu_torch import _build


def _tree(tmp_path):
    (tmp_path / "kern.cu").write_text(
        '#include <cuda_runtime.h>\n#include "common.cuh"\nint f() { return g(); }\n')
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                         "inline int g() { return h(); }\n")
    (tmp_path / "inner.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("inline int unused() { return 0; }\n")
    return tmp_path / "kern.cu"


def test_sources_of_follows_local_includes(tmp_path):
    src = _tree(tmp_path)
    assert [p.name for p in _build.sources_of(src)] == ["kern.cu", "common.cuh", "inner.cuh"]


def test_an_edited_header_changes_the_build_key(tmp_path):
    src = _tree(tmp_path)
    key = _build.build_key(src)
    assert key == _build.build_key(src)  # stable
    (tmp_path / "other.cuh").write_text("inline int unused() { return 2; }\n")
    assert _build.build_key(src) == key  # a header it does not include
    (tmp_path / "inner.cuh").write_text("#pragma once\ninline int h() { return 2; }\n")
    edited = _build.build_key(src)
    assert edited != key  # a header included through another header
    (tmp_path / "kern.cu").write_text(src.read_text() + "// note\n")
    assert _build.build_key(src) != edited


def test_every_kernel_source_keys_its_headers():
    """Each ``csrc/*.cu`` file's key covers the ``csrc`` headers it names."""
    for src in sorted(_build.CSRC.glob("*.cu")):
        named = {p.name for p in _build.sources_of(src)}
        text = src.read_text()
        for header in _build.CSRC.glob("*.cuh"):
            assert (f'"{header.name}"' in text) == (header.name in named)
