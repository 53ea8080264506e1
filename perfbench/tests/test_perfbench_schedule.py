"""The open loop: arrivals, and latency counted from the due time, so that a
stall of the server shows in the tail of every request due behind it."""

import asyncio
import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from perfbench import data
from perfbench.traffic import http_poisson as H


def test_every_seed_offers_the_same_gaps_in_its_own_order():
    t = {"rate": 100}
    a = H._arrivals(t, 1, 500, 5.0, 50)
    b = H._arrivals(t, 2, 500, 5.0, 50)
    assert a[0] == 0 and a[-1] < 5.0 and np.all(np.diff(a) >= 0)
    gaps = lambda x: np.sort(np.diff(np.append(x, 5.0)))  # the last gap ends the window
    assert np.allclose(gaps(a), gaps(b))
    assert not np.allclose(a, b)


def test_bursts_keep_the_mean_and_crowd_the_on_phase():
    t = {"rate": 100, "burst": {"period_s": 5.0, "on_s": 1.0, "factor": 4.0}}
    a = H._arrivals(t, 3, 2000, 20.0, 50)
    on = np.mean((a % 5.0) < 1.0)
    assert abs(on - 4 / 8) < 0.05  # 4 of 8 units of intensity lie in the on-phase
    assert a[-1] < 20.0


def test_lengths_are_a_fixed_set_in_a_seeded_order():
    draw = data.lognormal_lengths(1000, 6, 0.55, 1, 32)
    a = data.fixed_then_shuffled(1, 7, draw)
    b = data.fixed_then_shuffled(2**31 + 5, 7, draw)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert np.median(a) == 6 and a.min() >= 1 and a.max() <= 32


def _server(stall_at: int, stall_s: float):
    """A minimal HTTP server answering after ~1 ms, except that request
    ``stall_at`` holds the (single) worker for ``stall_s``."""
    count = {"n": 0}
    lock = asyncio.Lock()

    async def handle(reader, writer):
        while True:
            line = await reader.readline()
            if not line:
                break
            length = 0
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b""):
                    break
                if h.lower().startswith(b"content-length"):
                    length = int(h.split(b":")[1])
            await reader.readexactly(length)
            async with lock:  # one worker, as the program's server has
                count["n"] += 1
                await asyncio.sleep(stall_s if count["n"] == stall_at else 0.001)
            body = b'{"similar_documents": [{"id": 1}]}'
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n" % len(body) + body)
            await writer.drain()
        writer.close()

    loop = asyncio.new_event_loop()
    server = loop.run_until_complete(asyncio.start_server(handle, "127.0.0.1", 0))
    port = server.sockets[0].getsockname()[1]
    threading.Thread(target=loop.run_forever, daemon=True).start()
    return port, loop


@pytest.mark.parametrize("stall", [False, True])
def test_a_stall_shows_in_the_tail(tmp_path, stall):
    n, rate = 200, 100.0
    port, loop = _server(stall_at=50 if stall else -1, stall_s=0.4)
    offsets = np.arange(n) / rate
    plan = {"port": port, "t0": time.monotonic() + 0.5, "timeout_s": 10, "connections": 4,
            "keep": [3], "requests": [[float(o), json.dumps({"text": "x"})] for o in offsets]}
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    subprocess.run([sys.executable, str(H.LOADGEN), str(tmp_path / "plan.json"),
                    str(tmp_path / "out.json")], check=True, timeout=60)
    loop.call_soon_threadsafe(loop.stop)
    out = json.loads((tmp_path / "out.json").read_text())
    lat, failed, late = H.outcome(out["requests"], 10)
    assert failed == 0 and "3" in out["bodies"]
    p95 = np.percentile(lat, 95)
    if stall:
        # the 40 requests due in the 0.4 s behind the stall waited for it:
        # timed from their due times, well over 5% of the window is late
        assert p95 > 150, p95
        assert sum(x > 100 for x in lat) >= 20
    else:
        assert p95 < 50, p95
    assert late["p99"] < 50  # the generator itself kept to the schedule
