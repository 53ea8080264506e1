"""The JAX guard, and what the harness and its reference may import."""

import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import guard

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


@pytest.mark.parametrize("modules,found", [
    ({"torch", "rag_faiss_embedding_tpu_torch.index.flat"}, []),
    ({"jax.numpy", "numpy"}, ["jax"]),
    ({"rag_faiss_embedding_tpu.index", "rag_faiss_embedding_tpu_torch"},
     ["rag_faiss_embedding_tpu"]),
    ({"flax.linen", "optax", "orbax.checkpoint", "jaxlib"},
     ["flax", "jaxlib", "optax", "orbax"]),
])
def test_top_level_names_compared_whole(modules, found):
    assert guard.loaded(modules) == found


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        names = guard.imported_names(path)
        assert not names & {"rag_faiss_embedding_tpu_torch", *guard.FORBIDDEN}, path


def test_harness_imports_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not guard.imported_names(path) & set(guard.FORBIDDEN), path


def test_a_run_loads_no_jax():
    code = ("import sys, io; sys.path.insert(0, sys.argv[1]);"
            "from perfbench import harness, guard; from perfbench.tests.tiny import OVERRIDES;"
            "n = 'flat1m.http-poisson';"
            "harness.run(sys.argv[1], n, 9, 0.5, False, device='cpu', overrides=OVERRIDES[n],"
            " out=io.StringIO(), err=io.StringIO());"
            "print(guard.loaded())")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_a_loaded_jax_module_stops_the_run(monkeypatch):
    from perfbench import harness

    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(harness.RunError) as e:
        harness._guard("window")
    assert e.value.code != 0 and "jax" in str(e.value)


def test_no_card_exits_without_a_result():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "flat1m.http-poisson", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, io; sys.path.insert(0, sys.argv[1]);"
            "from perfbench import harness; from perfbench.tests.tiny import OVERRIDES;"
            "n = 'flat1m.http-poisson';"
            "harness.run(sys.argv[1], n, 9, 0.5, False, device='cpu', overrides=OVERRIDES[n])")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
