"""Host-side SQLite document store.

A copy of ``rag_faiss_embedding_tpu/store/database.py`` with the same
schema, so a database written by either package opens in the other.

Capability parity with BOTH reference schemas: the modular stack's
autoincrement table (``database.py:36-46``: id INTEGER PRIMARY KEY
AUTOINCREMENT, url UNIQUE, title, content) and the monolith's explicit-id
table with timestamps (``rag_datastore_manager.py:31-43``). This store uses
one unified schema — explicit-or-autoincrement id plus created_at/updated_at —
covering ``insert_documents``/``get_document_by_id``/``get_document_count``
(``database.py:48-80``) and ``fetch_document``/``fetch_all_documents``
(``rag_datastore_manager.py:67-97``).

By design (unlike the reference): no singleton, no FAISS store owned by the
database (``database.py:31-33`` couples them), thread-safe connections for
the API server, and single-transaction batch inserts.
"""

from __future__ import annotations

import sqlite3
import threading
from datetime import datetime, timezone
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from ..core.logging import get_logger

logger = get_logger(__name__)

_COLUMNS = ("id", "url", "title", "content", "created_at", "updated_at")


def _utcnow() -> str:
    return datetime.now(timezone.utc).isoformat()


def _row_to_doc(row) -> Dict:
    return dict(zip(_COLUMNS, row))


class Database:
    """SQLite document store with per-thread connections.

    NB: ``":memory:"`` paths get a separate empty database per thread (sqlite
    semantics) — use a file path for any multi-threaded use.
    """

    def __init__(self, db_path: str | Path = "data/documents.db"):
        self.db_path = str(db_path)
        if self.db_path != ":memory:":
            Path(self.db_path).parent.mkdir(parents=True, exist_ok=True)
        self._local = threading.local()
        self._create_table()
        logger.debug("initialized document store at %s", self.db_path)

    @property
    def conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.db_path)
            conn.execute("PRAGMA journal_mode=WAL")
            self._local.conn = conn
        return conn

    def _create_table(self) -> None:
        self.conn.execute(
            """
            CREATE TABLE IF NOT EXISTS documents (
                id INTEGER PRIMARY KEY,
                url TEXT UNIQUE,
                title TEXT,
                content TEXT,
                created_at TEXT,
                updated_at TEXT
            )
            """
        )
        self.conn.commit()

    def insert_documents(self, documents: Iterable[Dict]) -> List[int]:
        """Insert (or replace by url/id) documents; returns their row ids.

        Documents may carry an explicit ``id`` (monolith path,
        ``rag_datastore_manager.py:45-65``) or omit it for autoincrement
        (modular path, ``database.py:48-59``).
        """
        now = _utcnow()
        ids: List[int] = []
        cur = self.conn.cursor()
        for doc in documents:
            cur.execute(
                """
                INSERT OR REPLACE INTO documents
                    (id, url, title, content, created_at, updated_at)
                VALUES (?, ?, ?, ?, ?, ?)
                """,
                (
                    doc.get("id"),
                    doc["url"],
                    doc.get("title", ""),
                    doc.get("content", ""),
                    doc.get("created_at", now),
                    doc.get("updated_at", now),
                ),
            )
            if doc.get("id") is not None:
                ids.append(int(doc["id"]))
            else:
                ids.append(int(cur.lastrowid))
        self.conn.commit()
        logger.debug("inserted %d documents", len(ids))
        return ids

    def get_document_by_id(self, doc_id: int) -> Optional[Dict]:
        row = self.conn.execute(
            "SELECT id, url, title, content, created_at, updated_at"
            " FROM documents WHERE id = ?",
            (int(doc_id),),
        ).fetchone()
        return _row_to_doc(row) if row else None

    # Monolith-path alias (rag_datastore_manager.py:67-81)
    fetch_document = get_document_by_id

    def get_documents_by_ids(self, doc_ids: Iterable[int]) -> List[Optional[Dict]]:
        """Batched point lookups (one query, preserves input order)."""
        ids = [int(i) for i in doc_ids]
        if not ids:
            return []
        placeholders = ",".join("?" * len(ids))
        rows = self.conn.execute(
            "SELECT id, url, title, content, created_at, updated_at"
            f" FROM documents WHERE id IN ({placeholders})",
            ids,
        ).fetchall()
        by_id = {row[0]: _row_to_doc(row) for row in rows}
        # fresh dict per slot: callers attach per-hit fields (distance/score),
        # and duplicate ids must not alias one object
        return [dict(by_id[i]) if i in by_id else None for i in ids]

    def get_document_id_by_url(self, url: str) -> Optional[int]:
        row = self.conn.execute(
            "SELECT id FROM documents WHERE url = ?", (url,)
        ).fetchone()
        return int(row[0]) if row else None

    def fetch_all_documents(self) -> List[Dict]:
        rows = self.conn.execute(
            "SELECT id, url, title, content, created_at, updated_at"
            " FROM documents ORDER BY id"
        ).fetchall()
        return [_row_to_doc(r) for r in rows]

    # allowed metadata-predicate keys -> SQL fragment builders (search-time
    # filtering; no reference analog — vector-DB table stakes)
    _WHERE_KEYS = {
        "url_prefix": ("url LIKE ? ESCAPE '\\'", "prefix"),
        "url_contains": ("url LIKE ? ESCAPE '\\'", "contains"),
        "title_contains": ("title LIKE ? ESCAPE '\\'", "contains"),
        "content_contains": ("content LIKE ? ESCAPE '\\'", "contains"),
        "created_after": ("created_at > ?", "raw"),
        "created_before": ("created_at < ?", "raw"),
        "updated_after": ("updated_at > ?", "raw"),
    }

    @staticmethod
    def _like_escape(s: str) -> str:
        return (
            s.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
        )

    def select_ids(self, where: Dict) -> List[int]:
        """Resolve a structured metadata predicate to document ids.

        ``where`` keys (AND-ed): ``ids`` (explicit allowlist),
        ``url_prefix``, ``url_contains``, ``title_contains``,
        ``content_contains``, ``created_after`` / ``created_before`` /
        ``updated_after`` (ISO-8601 strings). All values are SQL
        parameters (LIKE wildcards in user input are escaped). Unknown
        keys raise ``ValueError``. Feeds the index tiers' search-time
        ``filter_mask`` (pre-filtering: predicate -> allowed ids -> masked
        scan)."""
        clauses: List[str] = []
        params: List = []
        for key, value in where.items():
            if key == "ids":
                ids = [int(i) for i in value]
                if not ids:
                    return []
                clauses.append(
                    f"id IN ({','.join('?' * len(ids))})"
                )
                params.extend(ids)
                continue
            if key not in self._WHERE_KEYS:
                raise ValueError(
                    f"unknown filter key {key!r}; allowed: "
                    f"{['ids', *self._WHERE_KEYS]}"
                )
            frag, kind = self._WHERE_KEYS[key]
            if kind == "prefix":
                params.append(self._like_escape(str(value)) + "%")
            elif kind == "contains":
                params.append("%" + self._like_escape(str(value)) + "%")
            else:
                params.append(str(value))
            clauses.append(frag)
        sql = "SELECT id FROM documents"
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        rows = self.conn.execute(sql + " ORDER BY id", params).fetchall()
        return [int(r[0]) for r in rows]

    def get_document_count(self) -> int:
        return int(self.conn.execute("SELECT COUNT(*) FROM documents").fetchone()[0])

    def delete_documents(self, doc_ids: Iterable[int]) -> int:
        """Delete documents by id; returns the number of rows removed.

        No reference analog — the reference only drops the whole database
        (``drop-database.py``); per-document deletion pairs with the index
        tiers' ``remove_ids``."""
        ids = [int(i) for i in doc_ids]
        if not ids:
            return 0
        placeholders = ",".join("?" * len(ids))
        cur = self.conn.execute(
            f"DELETE FROM documents WHERE id IN ({placeholders})", ids
        )
        self.conn.commit()
        logger.debug("deleted %d documents", cur.rowcount)
        return int(cur.rowcount)

    def delete_document_by_url(self, url: str) -> Optional[int]:
        """Delete one document by url; returns its id (None if absent)."""
        doc_id = self.get_document_id_by_url(url)
        if doc_id is not None:
            self.delete_documents([doc_id])
        return doc_id

    def delete_all(self) -> None:
        self.conn.execute("DELETE FROM documents")
        self.conn.commit()

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
