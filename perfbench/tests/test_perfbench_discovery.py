"""A later change adds a configuration, a cell and a metric as new files and
entries; the harness finds and runs them with no existing file edited."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVER = """
import json, sys
sys.path.insert(0, sys.argv[1])
from perfbench import harness
over = {"config": {"rows": {"n": 4096, "modes": 32}, "corpus": {"documents": 4096}}}
harness.run(sys.argv[1], "flat4k.vectors-q8", 5, 0.5, sys.argv[2] == "1", device="cpu",
            overrides=over)
"""


def _copy(tmp: Path) -> Path:
    root = tmp / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "rag_faiss_embedding_tpu_torch").symlink_to(ROOT / "rag_faiss_embedding_tpu_torch")
    return root


def _add(root: Path) -> None:
    """New files, and new entries in ``BENCHMARK.json``, only."""
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "minilm-l6.flat-f32-1m.json").read_text())
    (pb / "configs" / "minilm-l6.flat-f32-4k.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "flat4k.vectors-q8.json").write_text(json.dumps({
        "config": "minilm-l6.flat-f32-4k", "chips": 1, "kind": "vector_search",
        "why": "a test cell",
        "params": {"batch": 8, "batches": 4, "k": 10, "check_batches": 4},
        "limits": {"short": 0, "rank_gap": 1e-4, "dist_rel": 1e-4}}))
    (pb / "metrics" / "calls_per_s.py").write_text(
        'UNIT = "calls/s"\n\n\ndef read(ctx):\n'
        '    return ctx["rec"]["calls"] / ctx["window_s"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "minilm-l6.flat-f32-4k", "source": "test",
                             "file": "perfbench/configs/minilm-l6.flat-f32-4k.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "flat4k.vectors-q8", "config": "minilm-l6.flat-f32-4k",
                               "traffic": "vectors-q8", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("latency_p50_ms", "latency_p95_ms"):
            m["workloads"].append("flat4k.vectors-q8")
    bench["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                               "source": "host_clock", "layer": "test", "moves": "latency_p95_ms",
                               "workloads": ["flat4k.vectors-q8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _run(root: Path, trace: int) -> dict:
    p = subprocess.run([sys.executable, "-c", DRIVER, str(root), str(trace)], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_new_config_cell_and_metric_run_without_edits(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()
              and p.name != "BENCHMARK.json" and "rag_faiss" not in str(p)}
    _add(root)
    for p, content in before.items():  # no existing file of the harness changed
        assert p.read_bytes() == content, p
    r = _run(root, 0)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    r = _run(root, 1)
    assert r["metrics"]["calls_per_s"]["value"] > 0
