"""HTTP search API server with a micro-batcher in front of the card.

Counterpart of ``rag_faiss_embedding_tpu/serve/api.py``, serving the same
contract (reconstructed there from the reference's client and health
script, SURVEY.md §2 row 11):

    GET    /health     {"status", "documents", "vectors", "watchdog_error"}
    POST   /search     {"text": str, "top_k": int, "generate": bool,
                        "filter": {...}}
                       -> {"similar_documents": [...], "generated_response": str}
    GET    /stats      the batcher's StageTimer summary
    POST   /documents  {"documents": [...], "persist": bool} (with a manager)
    DELETE /documents  {"ids": [...], "urls": [...], "persist": bool}

with the same statuses: 400 for a body that is not JSON, 422 for a body
that fails validation, 501 without a manager, 503 from the watchdog, 404
for an unknown path and 405 for a known path with another method.

The JAX server is built on aiohttp. This one needs only the standard
library: ``asyncio.start_server`` and a minimal HTTP/1.1 reader (the
request line, the headers and a ``Content-Length`` body; keep-alive).
Every response carries ``Content-Length`` and ``Content-Type:
application/json``.

Concurrent requests are coalesced by a background batcher into one encoder
forward + one index scan (``QueryEngine.search_batch``, which launches the
flat scan kernel once, or the IVF union scan): a query waits at most
``batch_timeout_ms`` for co-riders, and the batch is searched at its
largest ``top_k``. Unlike the JAX server, every call that touches the
engine, the index or the manager (batch and filtered searches, answers,
adds, deletes, saves and the watchdog's probe) runs on ONE worker thread:
the port's indexes are written in place (``FlatIndex.add`` writes its
buffer at the watermark and reallocates it on growth), so a search must
not run beside an add.

Spans (``utils.timers``; they record while a torch profiler records on the
event loop's thread): each ``POST /search`` is a ``serve.request`` root
with its ``serve.queue_wait`` (queued to taken, naming the batch), and
each batch a ``serve.batch`` root (its rows and request ids) over the
engine's spans, which ``run`` carries to the worker thread.
"""

from __future__ import annotations

import argparse
import asyncio
import contextvars
import http
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set, Tuple
from urllib.parse import urlsplit

from ..core.config import Config
from ..core.logging import get_logger
from ..utils.timers import StageTimer, current, span

logger = get_logger(__name__)

MAX_BODY_BYTES = 1024 ** 2  # aiohttp's default client_max_size


class _PendingQuery:
    """A queued query; ``span`` is its request's span where spans record,
    and ``t0`` the monotonic time it was queued (then only)."""

    __slots__ = ("text", "top_k", "future", "span", "t0")

    def __init__(self, text: str, top_k: int, future: asyncio.Future):
        self.text = text
        self.top_k = top_k
        self.future = future
        self.span = current()
        self.t0 = time.monotonic_ns() if self.span is not None else 0


class SearchService:
    """Batching front of a QueryEngine; usable without HTTP for tests.

    Owns the worker thread that every engine call runs on (``run``)."""

    def __init__(
        self,
        engine,
        max_batch: int = 64,
        batch_timeout_ms: float = 2.0,
    ):
        self.engine = engine
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1e3
        self.queue: asyncio.Queue = asyncio.Queue()
        self.timer = StageTimer()
        self._task: Optional[asyncio.Task] = None
        self._worker: Optional[ThreadPoolExecutor] = None

    async def run(self, fn: Callable, *args):
        """``fn(*args)`` on the service's one worker thread, in a copy of
        the caller's context (so the call's spans have the caller's span
        for parent)."""
        if self._worker is None:
            self._worker = ThreadPoolExecutor(1, thread_name_prefix="search-worker")
        return await asyncio.get_running_loop().run_in_executor(
            self._worker, contextvars.copy_context().run, fn, *args)

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._batch_loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        while not self.queue.empty():  # nobody will search these now
            p = self.queue.get_nowait()
            if not p.future.done():
                p.future.set_exception(RuntimeError("search service stopped"))
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    async def search(self, text: str, top_k: int,
                     where: Optional[dict] = None) -> List[dict]:
        if where is not None:
            # filtered queries run unbatched: the coalescer shares ONE scan
            # across co-riders, and filters are per-request
            return await self.run(self.engine.search, text, top_k, where)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self.queue.put(_PendingQuery(text, top_k, fut))
        return await fut

    async def _collect_batch(self) -> List[_PendingQuery]:
        first = await self.queue.get()
        batch = [first]
        deadline = asyncio.get_running_loop().time() + self.batch_timeout
        while len(batch) < self.max_batch:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                break
            try:
                batch.append(
                    await asyncio.wait_for(self.queue.get(), timeout=remaining)
                )
            except asyncio.TimeoutError:
                break
        return batch

    async def _batch_loop(self) -> None:
        while True:
            batch = await self._collect_batch()
            try:
                texts = [p.text for p in batch]
                k = max(p.top_k for p in batch)
                with span("serve.batch", rows=len(batch)) as s:
                    if s:
                        traced = [p for p in batch if p.span is not None]
                        s.add(requests=[p.span.request for p in traced])
                        for p in traced:
                            p.span.record("serve.queue_wait", p.t0, s.t0, batch=s.id)
                    with self.timer.stage(f"batch_search(n={len(batch)})"):
                        results = await self.run(self.engine.search_batch, texts, k)
                for p, docs in zip(batch, results):
                    if not p.future.done():
                        p.future.set_result(docs[: p.top_k])
            except Exception as e:
                logger.exception("batch search failed")
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)


class _BadRequest(Exception):
    """A request the HTTP reader cannot take: answered, then closed."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status


def _json_body(body: bytes) -> Optional[dict]:
    """The request's JSON object, or None where the body is not JSON."""
    try:
        data = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError):
        return None
    return data if isinstance(data, dict) else None


class SearchApp:
    """The HTTP server: ``await start(host, port)`` (port 0 binds a free
    port, then in ``port``), ``await stop()``. ``probe()`` runs one watchdog
    self-probe."""

    def __init__(self, engine, config: Config, manager=None):
        self.engine = engine
        self.config = config
        self.manager = manager
        self.service = SearchService(
            engine,
            max_batch=config.serve_max_batch,
            batch_timeout_ms=config.serve_batch_timeout_ms,
        )
        # failure detection: a periodic end-to-end self-probe (embed +
        # scan); /health degrades to 503 when the device path stops answering
        self.watchdog = {"status": "healthy", "last_ok": None, "error": None}
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: Set[asyncio.Task] = set()
        self.routes: Dict[str, Dict[str, Callable]] = {
            "/health": {"GET": self.health},
            "/search": {"POST": self.search},
            "/stats": {"GET": self.stats},
            "/documents": {"POST": self.add_documents, "DELETE": self.delete_documents},
        }

    # ------------------------------------------------------------ lifecycle
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        await self.service.start()
        interval = self.config.serve_watchdog_interval_s
        if interval > 0:
            self._spawn(self._watchdog_loop(interval))
        self._server = await asyncio.start_server(self._connection, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("serving on %s:%d", host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
        for task in list(self._tasks):  # idle keep-alive connections too
            task.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
        await self.service.stop()

    def _spawn(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def probe(self, timeout_s: float = 60.0) -> None:
        """One self-probe through the search path; sets the watchdog."""
        loop = asyncio.get_running_loop()
        try:
            await asyncio.wait_for(
                self.service.run(self.engine.search_batch, ["__healthcheck__"], 1),
                timeout=timeout_s,
            )
            self.watchdog.update(status="healthy", last_ok=loop.time(), error=None)
        except Exception as e:
            self.watchdog.update(status="unhealthy", error=str(e))
            logger.error("watchdog probe failed: %s", e)

    async def _watchdog_loop(self, interval_s: float) -> None:
        while True:
            await self.probe(timeout_s=max(interval_s, 60.0))
            await asyncio.sleep(interval_s)

    # ---------------------------------------------------------------- HTTP
    async def _connection(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        self._tasks.add(asyncio.current_task())
        try:
            while True:
                try:
                    request = await self._read_request(reader, writer)
                except _BadRequest as e:
                    await self._respond(writer, e.status, {"detail": str(e)}, False)
                    break
                if request is None:
                    break
                method, path, body, keep_alive = request
                status, payload, headers = await self._dispatch(method, path, body)
                await self._respond(writer, status, payload, keep_alive, headers)
                if not keep_alive:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            self._tasks.discard(asyncio.current_task())
            writer.close()

    @staticmethod
    async def _read_request(reader, writer) -> Optional[Tuple[str, str, bytes, bool]]:
        """(method, path, body, keep-alive) of the next request, or None at
        the end of the connection."""
        try:
            line = await reader.readline()
            if not line:
                return None
            parts = line.decode("latin-1").split()
            if len(parts) != 3 or not parts[2].startswith("HTTP/"):
                raise _BadRequest(400, "malformed request line")
            method, target, version = parts
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, value = line.decode("latin-1").partition(":")
                headers[name.strip().lower()] = value.strip()
        except ValueError:  # a line past the reader's limit
            raise _BadRequest(400, "request line or header too long")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _BadRequest(400, "chunked request bodies are not supported")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "invalid Content-Length")
        if length < 0:
            raise _BadRequest(400, "invalid Content-Length")
        if length > MAX_BODY_BYTES:
            raise _BadRequest(413, f"request body larger than {MAX_BODY_BYTES} bytes")
        if length and headers.get("expect", "").lower() == "100-continue":
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")  # curl waits for it
            await writer.drain()
        body = await reader.readexactly(length) if length else b""
        connection = headers.get("connection", "").lower()
        keep_alive = connection != "close" and (version == "HTTP/1.1"
                                                or connection == "keep-alive")
        return method.upper(), urlsplit(target).path, body, keep_alive

    async def _dispatch(self, method: str, path: str, body: bytes):
        methods = self.routes.get(path)
        if methods is None:
            return 404, {"detail": "Not Found"}, {}
        handler = methods.get(method)
        if handler is None:
            return 405, {"detail": "Method Not Allowed"}, {"Allow": ",".join(sorted(methods))}
        try:
            status, payload = await handler(body)
        except Exception:
            logger.exception("%s %s failed", method, path)
            return 500, {"detail": "internal server error"}, {}
        return status, payload, {}

    @staticmethod
    async def _respond(writer, status: int, payload, keep_alive: bool,
                       headers: Optional[dict] = None) -> None:
        data = json.dumps(payload).encode()
        lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}",
                 "Content-Type: application/json; charset=utf-8",
                 f"Content-Length: {len(data)}",
                 f"Connection: {'keep-alive' if keep_alive else 'close'}"]
        lines += [f"{k}: {v}" for k, v in (headers or {}).items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + data)
        await writer.drain()

    # ------------------------------------------------------------- routes
    async def health(self, body: bytes):
        healthy = self.watchdog["status"] == "healthy"
        return (200 if healthy else 503), {
            "status": self.watchdog["status"],
            "documents": self.engine.db.get_document_count(),
            "vectors": self.engine.vector_store.nlive,
            "watchdog_error": self.watchdog["error"],
        }

    async def search(self, body: bytes):
        with span("serve.request"):
            req = _json_body(body)
            if req is None:
                return 400, {"detail": "invalid JSON body"}
            text = req.get("text")
            if not isinstance(text, str) or not text.strip():
                return 422, {"detail": "'text' must be a non-empty string"}
            top_k = req.get("top_k", self.config.top_k)
            if not isinstance(top_k, int) or top_k <= 0:
                return 422, {"detail": "'top_k' must be a positive integer"}
            generate = bool(req.get("generate", True))
            where = req.get("filter")
            if where is not None and not isinstance(where, dict):
                return 422, {"detail": "'filter' must be an object of metadata predicates"}
            try:
                docs = await self.service.search(text, top_k, where=where)
            except ValueError as e:  # unknown filter key
                return 422, {"detail": str(e)}
            response = {"similar_documents": docs}
            if generate:
                response["generated_response"] = await self.service.run(
                    self.engine.generate_response, text, docs)
            return 200, response

    async def stats(self, body: bytes):
        return 200, self.service.timer.summary()

    async def add_documents(self, body: bytes):
        if self.manager is None:
            return 501, {"detail": "document ingestion not enabled"}
        req = _json_body(body)
        if req is None:
            return 400, {"detail": "invalid JSON body"}
        documents = req.get("documents")
        if not isinstance(documents, list) or not documents:
            return 422, {"detail": "'documents' must be a non-empty list"}
        for doc in documents:
            if not isinstance(doc, dict) or "url" not in doc or "content" not in doc:
                return 422, {"detail": "each document needs 'url' and 'content'"}
        persist = bool(req.get("persist", False))

        def add():
            n = self.manager.add_documents(documents)
            if persist:
                self.manager.vector_store.save_index()
            return n, self.engine.vector_store.ntotal

        n, vectors = await self.service.run(add)
        return 200, {"added": n, "vectors": vectors}

    async def delete_documents(self, body: bytes):
        if self.manager is None:
            return 501, {"detail": "document management not enabled"}
        req = _json_body(body)
        if req is None:
            return 400, {"detail": "invalid JSON body"}
        ids = req.get("ids", [])
        urls = req.get("urls", [])
        if not isinstance(ids, list) or not isinstance(urls, list):
            return 422, {"detail": "'ids' and 'urls' must be lists"}
        if not ids and not urls:
            return 422, {"detail": "provide 'ids' and/or 'urls' to delete"}
        n = await self.service.run(self.manager.delete_documents, ids, urls,
                                   bool(req.get("persist", False)))
        return 200, {"deleted": n, "documents": self.engine.db.get_document_count()}


def make_app(engine, config: Optional[Config] = None, manager=None) -> SearchApp:
    """The server over ``engine``. ``manager`` (a RAGManager) enables
    POST / DELETE /documents, streaming writes into the live index."""
    return SearchApp(engine, config or Config.from_env(), manager=manager)


def build_generator(cfg: Config, embedder):
    """The answer generator ``cfg`` names (``generator_backend``), the
    native one on the embedder's device."""
    from ..models.generator import AnswerGenerator

    return AnswerGenerator.from_config(cfg, device=embedder.device)


async def _serve(app: SearchApp, host: str, port: int) -> None:
    await app.start(host, port)
    print(f"serving on http://{host}:{app.port}", flush=True)
    try:
        await asyncio.Event().wait()  # until interrupted
    finally:
        await app.stop()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="RAG search API server")
    parser.add_argument("--base-dir", default=".")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' only when asked)")
    args = parser.parse_args(argv)

    cfg = Config.from_env(base_dir=args.base_dir)
    from ..rag.engine import QueryEngine
    from ..rag.manager import RAGManager

    manager = RAGManager(config=cfg, device=args.device)
    manager.load_indices()
    engine = QueryEngine(
        manager.db,
        manager.vector_store,
        manager.embedder,
        generator=build_generator(cfg, manager.embedder),
        context_token_budget=cfg.context_token_budget,
    )
    app = make_app(engine, cfg, manager=manager)
    host = args.host or cfg.api_host
    port = cfg.api_port if args.port is None else args.port
    try:
        asyncio.run(_serve(app, host, port))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
