"""Open-loop HTTP load generator, run in a process of its own.

    python loadgen.py <plan.json> <result.json>

The plan gives the server's port, the start ``t0`` on the monotonic clock
(shared by every process of the machine), and the requests as (due offset
in seconds, JSON body). Each request is sent at its due time whether or not
earlier ones have been answered, on an idle keep-alive connection or a new
one, and timed from its due time to the last byte of its answer. It uses
the standard library only, and its own interpreter, so it does not share
the server's GIL.

The result: for each request [due, sent, done, status, empty answer] on the
monotonic clock (done -1 for one that never came), and the bodies of the
requests the plan asks to keep.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


class Pool:
    def __init__(self, port: int):
        self.port, self.idle = port, []

    async def get(self):
        if self.idle:
            return self.idle.pop()
        return await asyncio.open_connection("127.0.0.1", self.port)

    def put(self, conn) -> None:
        self.idle.append(conn)


async def exchange(conn, payload: bytes):
    reader, writer = conn
    writer.write(payload)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    length = 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            length = int(value)
    return status, await reader.readexactly(length)


async def run(plan: dict) -> dict:
    pool = Pool(plan["port"])
    pool.idle = [await pool.get() for _ in range(plan["connections"])]
    keep = set(plan["keep"])
    t0, timeout = plan["t0"], plan["timeout_s"]
    out = [None] * len(plan["requests"])
    bodies = {}

    async def one(i: int, due: float, payload: bytes):
        sent = time.monotonic()
        try:
            conn = await pool.get()
            status, body = await asyncio.wait_for(exchange(conn, payload), timeout)
            pool.put(conn)
            done = time.monotonic()
        except (asyncio.TimeoutError, OSError, ValueError, IndexError,
                asyncio.IncompleteReadError):
            out[i] = [due, sent, -1.0, 0, True]
            return
        out[i] = [due, sent, done, status, b'"similar_documents": []' in body]
        if i in keep:
            bodies[str(i)] = body.decode()

    head = (f"POST /search HTTP/1.1\r\nHost: 127.0.0.1:{plan['port']}\r\n"
            "Content-Type: application/json\r\n")
    tasks = []
    for i, (offset, body) in enumerate(plan["requests"]):
        data = body.encode()
        payload = (head + f"Content-Length: {len(data)}\r\n\r\n").encode() + data
        due = t0 + offset
        wait = due - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        tasks.append(asyncio.create_task(one(i, due, payload)))
    await asyncio.gather(*tasks)
    for reader, writer in pool.idle:
        writer.close()
    return {"requests": out, "bodies": bodies}


def main(argv) -> int:
    with open(argv[1]) as f:
        plan = json.load(f)
    result = asyncio.run(run(plan))
    with open(argv[2], "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
