"""One run of one cell: set-up, the measured window, the metrics, the check.

``run`` is what ``run.py`` calls; the tests call it too, with
``device="cpu"`` and smaller sizes, to drive every step but the look for a
card. Its last line on standard output is the result's JSON object; the
numbers that decide ``correct`` are its last lines on standard error.
"""

from __future__ import annotations

import bisect
import json
import shutil
import subprocess
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path

from . import guard, work
from .registry import Registry, merged


class RunError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def _devices(torch, chips: int, device):
    if device is not None:
        return [torch.device(device)] * chips
    if not torch.cuda.is_available():
        raise RunError(2, "no CUDA device is visible")
    if torch.cuda.device_count() < chips:
        raise RunError(2, f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")
    return [torch.device("cuda", i) for i in range(chips)]


def _guard(where: str) -> None:
    found = guard.loaded()
    if found:
        raise RunError(3, f"{where}: forbidden modules loaded: {', '.join(found)}")


def _innermost(spans: list, starts: list, t: int) -> str:
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 64), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return "outside any span"


def _device_summary(dev, spans: dict, t0: int, t1: int, n_cards: int) -> dict:
    """Busy time per card, device time by operation, and idle time on the
    first card by the innermost host span open at each gap's middle."""
    from .tracing import busy_ns

    events = dev.crop(t0, t1)
    by_card = defaultdict(list)
    by_name = defaultdict(int)
    for name, card, a, b in events:
        by_card[card].append((a, b))
        by_name[name] += b - a
    busy = [busy_ns(by_card.get(c, [])) / 1e9 for c in range(n_cards)]
    flat = sorted((a, b, n) for n, v in spans.items() for a, b, _ in v)
    starts = [s[0] for s in flat]
    idle, end = defaultdict(int), t0
    for a, b in sorted(by_card.get(0, [])) + [(t1, t1)]:
        if a > end:
            idle[_innermost(flat, starts, (a + end) // 2)] += a - end
        end = max(end, b)
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"events": events, "busy_s": busy, "device_ops": top(by_name), "idle_gaps": top(idle)}


def _trace_context(program, spans, dev, rec, n_cards) -> dict:
    t0, t1 = rec["t0"], rec["t1"]
    ctx_spans = spans.between(t0, t1)
    calls = []
    cache = {}
    for _, _, m in ctx_spans.get("vector_store.search", []):
        key = (id(m["q"]), m["k"])
        if key not in cache:
            cache[key] = program.search_work(m["q"].reshape(-1, m["q"].shape[-1]), m["k"])
        calls.append(cache[key])
    lengths = [n for _, _, m in ctx_spans.get("tokenizer.encode_batch", []) for n in m["real"]]
    ctx = {"spans": ctx_spans, "search_work": calls, "encoder_lengths": lengths}
    if dev.enabled:
        ctx["device"] = _device_summary(dev, ctx_spans, t0, t1, n_cards)
    return ctx


def _power_line(devices) -> str:
    if devices[0].type != "cuda":
        return "card: cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return "card: " + " | ".join(out.splitlines()[: len(devices)])


def run(root, cell_name: str, seed: int, seconds: float, trace: bool, *, t_start=None,
        device=None, overrides=None, control=None, out=None, err=None) -> dict:
    """Run one cell once and print its result. ``control`` ("tf32",
    "fp8") puts the reference, in that precision, in the program's place
    and skips the window: it gives the check's upper readings."""
    import torch

    from .system import Inputs

    out, err = out or sys.stdout, err or sys.stderr
    t_start = t_start if t_start is not None else time.monotonic_ns()
    root = Path(root)
    reg = Registry(root)
    overrides = overrides or {}
    cell = merged(reg.cell(cell_name), overrides.get("cell"))
    config = merged(reg.config(cell["config"]), overrides.get("config"))
    devices = _devices(torch, cell["chips"], device)
    _guard("start")
    traffic = reg.traffic(cell["kind"])
    workdir = root / ".perfbench" / "run"
    shutil.rmtree(workdir, ignore_errors=True)
    inputs = Inputs(config, seed, devices)
    plan = traffic.plan(cell, inputs, seed, seconds)
    try:
        if control:
            answers = traffic.control(inputs, plan, control)
            return _finish(cell, traffic.judge(inputs, plan, answers), None, out, err)
        return _measure(reg, cell, config, traffic, inputs, plan, workdir, devices, seconds,
                        trace, t_start, out, err)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _measure(reg, cell, config, traffic, inputs, plan, workdir, devices, seconds, trace,
             t_start, out, err) -> dict:
    import torch

    from .system import Program
    from .tracing import DeviceTrace, Spans

    cuda = devices[0].type == "cuda"
    program = Program(inputs, workdir)
    traffic.prepare(program, plan)
    spans = Spans(trace)
    traffic.instrument(program, spans)
    dev = DeviceTrace(trace and cuda)
    if cuda:
        for d in devices:
            torch.cuda.reset_peak_memory_stats(d)
    _guard("set-up")
    rec = traffic.window(program, plan, seconds, dev)
    setup_s = (rec["t0"] - t_start) / 1e9
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
    _guard("window")
    ctx = {"setup_s": setup_s, "window_s": rec["window_s"], "rec": rec, "cell": cell,
           "config": config, "model": config["model"], "work": work}
    if trace:
        ctx.update(_trace_context(program, spans, dev, rec, len(devices)))
    metrics = {}
    for m in reg.metrics(cell["name"], trace):
        value = reg.reader(m["name"]).read(ctx)
        if value is None:
            if not trace:
                raise RunError(1, f"end-to-end metric {m['name']} has no value")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    got = traffic.collect(program, plan, rec)
    program.free()
    checks = traffic.judge(inputs, plan, got)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    result = {"attempted": rec["attempted"], "failed": rec["failed"], "metrics": metrics,
              "device": device}
    if trace and "device" in ctx:
        d = ctx["device"]
        device.update(busy_s=sum(d["busy_s"]) / len(d["busy_s"]), window_s=rec["window_s"])
        result["breakdown"] = {"device_ops": d["device_ops"], "idle_gaps": d["idle_gaps"]}
    print(_power_line(devices), file=err)
    print("set-up stages s: " + json.dumps(inputs.timings), file=err)
    if "lateness_ms" in rec:
        print("load generator lateness ms: " + json.dumps(rec["lateness_ms"]), file=err)
    return _finish(cell, checks, result, out, err)


def _finish(cell, checks: dict, result, out, err) -> dict:
    _guard("result")
    limits = cell["limits"]
    compared = {n: {"value": checks.get(n, float("inf")), "limit": lim}
                for n, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    info = {n: v for n, v in checks.items() if n not in limits}
    print("check information: " + json.dumps(info), file=err)
    result = dict(result or {"attempted": 0, "failed": 0, "metrics": {}, "device": {}})
    result = {"correct": correct, **result, "checks": compared}
    for n, c in compared.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv, t_start: int, root: Path) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        run(root, args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    except Exception:
        traceback.print_exc()
        return 1
    return 0
