"""The two sweeps whose results are written into the cell and config files.

    python3 perfbench/sweep.py knee --workload flat1m.http-poisson \
        --rates 200,400,600 --seconds 10 --seed 1
    python3 perfbench/sweep.py nprobe --workload ivf1m.vectors-q1024 \
        --nprobes 4,8,12,16,24,32,48,64 --seeds 1,2,3,4

``knee`` builds the cell's program once and offers each rate in turn, from
the lowest, to the served path for ``--seconds``. A rate is sustained where
every request is answered and no quarter of the window holds a backlog: the
median latency of the requests due in each quarter stays within 1.5 times
the median at the lowest rate (where a request waits for little but its own
batch). The knee is the highest sustained rate; the cell runs at half of it,
below the rates at which one gen-2 garbage collection pause of the server
(130-210 ms) leaves a backlog for the rest of a window.

``nprobe`` builds the IVF index of each seed and measures recall@10 of the
search at each nprobe against the reference's float64 exact top-10, over
the cell's query batches. The configuration takes the least nprobe whose
lowest recall over the seeds is at least 0.993: the gate, 0.99, with 30% of
its misses left as room for seeds the sweep did not draw.

Each line of output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.harness import _devices  # noqa: E402
from perfbench.registry import Registry, merged  # noqa: E402
from perfbench.system import Inputs, Program  # noqa: E402
from perfbench.tracing import DeviceTrace  # noqa: E402


def _setup(name: str, seed: int, device, overrides=None):
    reg = Registry(ROOT)
    overrides = overrides or {}
    cell = merged(reg.cell(name), overrides.get("cell"))
    config = merged(reg.config(cell["config"]), overrides.get("config"))
    inputs = Inputs(config, seed, _devices(torch, cell["chips"], device))
    workdir = ROOT / ".perfbench" / "sweep"
    shutil.rmtree(workdir, ignore_errors=True)
    return reg, cell, inputs, Program(inputs, workdir)


def knee(name: str, rates: list, seconds: float, seed: int, device=None, overrides=None):
    from perfbench.traffic import http_poisson as H

    reg, cell, inputs, program = _setup(name, seed, device, overrides)
    out, base = [], None
    for i, rate in enumerate(sorted(rates)):
        c = merged(cell, {"params": {"rate": rate}})
        p = H.plan(c, inputs, seed + i, seconds)
        if i == 0:
            H.prepare(program, p)
        rec = H.window(program, p, seconds, DeviceTrace(False))
        lat = np.asarray(rec["latencies_ms"])  # in order of due time
        quarters = [float(np.median(part)) for part in np.array_split(lat, 4)]
        p50 = float(np.percentile(lat, 50))
        base = base or p50
        row = {"rate": rate, "requests": len(lat), "failed": rec["failed"], "p50_ms": p50,
               "p95_ms": float(np.percentile(lat, 95)), "p99_ms": float(np.percentile(lat, 99)),
               "quarter_p50_ms": quarters,
               "batch_rows_mean": (sum(n * k for n, k in rec["batches"].items())
                                   / max(1, sum(rec["batches"].values()))),
               "lateness_ms": rec["lateness_ms"]}
        row["sustained"] = rec["failed"] == 0 and max(quarters) <= 1.5 * base
        print(json.dumps(row), flush=True)
        out.append(row)
    shutil.rmtree(program.workdir, ignore_errors=True)
    return out


def nprobe(name: str, nprobes: list, seeds: list, device=None, overrides=None):
    from perfbench.traffic import vector_search as V

    out = []
    for seed in seeds:
        reg, cell, inputs, program = _setup(name, seed, device, overrides)
        p = V.plan(cell, inputs, seed, 0)
        k = p["t"]["k"]
        q = p["q"].reshape(-1, p["q"].shape[-1])
        _, truth = V._exact(inputs, q, k).result()
        truth = (truth + 1).tolist()
        idx = program.index
        for npb in nprobes:
            hits = 0
            for b in range(len(p["q"])):
                _, ids = idx.search(p["q"][b], k, nprobe=npb)
                got = ids.cpu().numpy() + 1
                hits += sum(len(set(a.tolist()) & set(t)) for a, t in
                            zip(got, truth[b * p["q"].shape[1]:(b + 1) * p["q"].shape[1]]))
            row = {"seed": seed, "nprobe": npb, "recall_at_10": hits / (len(q) * k)}
            print(json.dumps(row), flush=True)
            out.append(row)
        shutil.rmtree(program.workdir, ignore_errors=True)
        del idx
        program.free()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kind", choices=("knee", "nprobe"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="")
    ap.add_argument("--nprobes", default="")
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seeds", default="1")
    a = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    if a.kind == "knee":
        knee(a.workload, [float(r) for r in a.rates.split(",")], a.seconds, a.seed)
    else:
        nprobe(a.workload, [int(n) for n in a.nprobes.split(",")],
               [int(s) for s in a.seeds.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
