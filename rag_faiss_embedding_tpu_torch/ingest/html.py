"""HTML corpus ingestion and extractive summarization.

Counterpart of ``rag_faiss_embedding_tpu/ingest/html.py`` (the reference's
``TextSummarizer``, ``process_unstructured_html.py:64-287``): walk
``**/*.html`` skipping ``index.html``, strip script/style/nav/footer/header
while preserving ``<pre>`` blocks, prefer main/article/section content,
regex-clean the text, summarize to <= ``max_sentences`` key sentences /
<= ``max_content_length`` chars with near-duplicate-sentence suppression
(similarity > 0.7), number the entries 1..n in sorted-path order, and write
``data/documents.json`` entries with ``id,url,title,content,created_at,
updated_at``.

The JAX module parses with BeautifulSoup. This one needs no package beyond
the standard library: ``parse_html`` builds a small element tree from
``html.parser.HTMLParser``'s events the way BeautifulSoup's ``html.parser``
back end does (an end tag closes up to its open twin and an unmatched one is
dropped, void elements take no children, character references are
converted, comments / declarations / processing instructions are not text,
and neither are the strings inside ``script``, ``style``, ``template``,
``rt`` and ``rp``), and ``Element`` offers the operations the extraction
uses (``find_all``, ``extract``, ``decompose``, ``get_text``). So the text
extracted for a page is the string BeautifulSoup gives.
"""

from __future__ import annotations

import itertools
import json
import re
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timezone
from html.entities import html5
from html.parser import HTMLParser
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Union

from ..core.logging import get_logger
from ..utils.text import cosine_sim, sentence_split, tf_vector

logger = get_logger(__name__)

DEFAULT_MAX_CONTENT_LENGTH = 512
DEFAULT_MAX_SENTENCES = 2
_SIMILARITY_DEDUP = 0.7

# the elements BeautifulSoup's HTML back end treats as void (no children)
_VOID = frozenset((
    "area", "base", "basefont", "bgsound", "br", "col", "command", "embed",
    "frame", "hr", "image", "img", "input", "isindex", "keygen", "link",
    "menuitem", "meta", "nextid", "param", "source", "spacer", "track", "wbr"))
# elements whose strings are not page text (BeautifulSoup gives them their
# own string classes, which get_text leaves out)
_STRING_CONTAINERS = frozenset(("rt", "rp", "style", "script", "template"))
# named references with and without their ';', as BeautifulSoup resolves them
_ENTITIES = {}
for _name, _char in html5.items():
    _ENTITIES.setdefault(_name.rstrip(";"), _char)


class _String(str):
    """A string of the tree; ``is_text`` is False for the strings that are
    not page text (comments, declarations, the strings of ``_STRING_CONTAINERS``)."""

    is_text = True


class _Other(_String):
    is_text = False


class Element:
    """One tag of a parsed page."""

    __slots__ = ("name", "parent", "children")

    def __init__(self, name: str, parent: Optional["Element"] = None):
        self.name = name
        self.parent = parent
        self.children: List[Union["Element", _String]] = []

    def descendants(self) -> Iterator[Union["Element", _String]]:
        """Every node below this one, in document order (no recursion: an
        unclosed tag per line nests a page thousands deep)."""
        todo = self.children[::-1]
        while todo:
            node = todo.pop()
            yield node
            if isinstance(node, Element):
                todo.extend(node.children[::-1])

    def find_all(self, names: Union[str, Sequence[str]]) -> List["Element"]:
        names = {names} if isinstance(names, str) else set(names)
        return [n for n in self.descendants()
                if isinstance(n, Element) and n.name in names]

    def extract(self) -> "Element":
        """Detach this element (and what it holds) from its parent."""
        if self.parent is not None:
            siblings = self.parent.children
            del siblings[next(i for i, n in enumerate(siblings) if n is self)]
            self.parent = None
        return self

    decompose = extract

    def get_text(self, separator: str = "", strip: bool = False) -> str:
        """The page text below this element, as BeautifulSoup's ``get_text``."""
        parts = (s.strip() if strip else s for s in self.descendants()
                 if isinstance(s, _String) and s.is_text)
        return separator.join(p for p in parts if p or not strip)


def _numeric_reference(name: str) -> str:
    """The character of ``&#name;`` (``name`` as HTMLParser passes it:
    decimal digits, or x and hex digits), as BeautifulSoup resolves it (the
    HTML standard's numeric character reference end state)."""
    code = int(name[1:], 16) if name[:1] in ("x", "X") else int(name)
    if code == 0 or code > 0x10FFFF or 0xD800 <= code <= 0xDFFF:
        return "\ufffd"
    if 0x80 <= code <= 0x9F:
        try:  # a Windows-1252 byte written as a reference
            return bytes([code]).decode("cp1252")
        except UnicodeDecodeError:
            pass
    return chr(code)


class _TreeParser(HTMLParser):
    """HTMLParser events -> an ``Element`` tree, by the rules of
    BeautifulSoup's ``html.parser`` back end."""

    def __init__(self):
        super().__init__(convert_charrefs=False)
        self.root = Element("[document]")
        self._stack = [self.root]
        self._open: Counter = Counter()
        self._containers: List[Element] = []
        self._data: List[str] = []
        self._closed_void: List[str] = []

    def _flush(self, cls=None) -> None:
        if not self._data:
            return
        text = "".join(self._data)
        self._data = []
        if cls is None:
            cls = _Other if self._containers else _String
        self._stack[-1].children.append(cls(text))

    def _pop(self) -> None:
        tag = self._stack.pop()
        self._open[tag.name] -= 1
        if self._containers and self._containers[-1] is tag:
            self._containers.pop()

    def handle_starttag(self, tag, attrs, void: bool = True):
        self._flush()
        el = Element(tag, self._stack[-1])
        self._stack[-1].children.append(el)
        self._stack.append(el)
        self._open[tag] += 1
        if tag in _STRING_CONTAINERS:
            self._containers.append(el)
        if void and tag in _VOID:
            self.handle_endtag(tag, check_void=False)
            self._closed_void.append(tag)

    def handle_startendtag(self, tag, attrs):
        self.handle_starttag(tag, attrs, void=False)
        self.handle_endtag(tag, check_void=False)

    def handle_endtag(self, tag, check_void: bool = True):
        if check_void and tag in self._closed_void:
            self._closed_void.remove(tag)  # </br> after <br>: already closed
            return
        self._flush()
        for i in range(len(self._stack) - 1, 0, -1):  # up to the open twin
            if not self._open[tag]:
                break  # none open: the end tag is dropped
            name = self._stack[i].name
            self._pop()
            if name == tag:
                break

    def handle_data(self, data):
        self._data.append(data)

    def handle_charref(self, name):
        self._data.append(_numeric_reference(name))

    def handle_entityref(self, name):
        self._data.append(_ENTITIES.get(name, f"&{name}"))

    def _other(self, text: str, cls=_Other) -> None:
        self._flush()
        self._data.append(text)
        self._flush(cls)

    def handle_comment(self, data):
        self._other(data)

    def handle_decl(self, decl):
        self._other(decl[len("DOCTYPE "):])

    def handle_pi(self, data):
        self._other(data)

    def unknown_decl(self, data):
        if data.upper().startswith("CDATA["):
            self._other(data[len("CDATA["):], _String)  # CDATA is page text
        else:
            self._other(data)

    def finish(self) -> Element:
        self.close()
        self._flush()
        return self.root


def parse_html(markup: str) -> Element:
    """The element tree of a page (its root holds the top-level nodes)."""
    parser = _TreeParser()
    parser.feed(markup)
    return parser.finish()


class IndexEntry:
    """One summarized document (reference ``process_unstructured_html.py:40-62``).

    Ids default to a thread-safe incremental counter; ``generate_index``
    re-assigns them in deterministic sorted-path order after the parallel
    extraction completes (the reference increments the counter from worker
    threads, which both races and shuffles ids by completion order)."""

    _counter = itertools.count(1)

    def __init__(self, url: str, title: str, content: str,
                 max_content_length: int = DEFAULT_MAX_CONTENT_LENGTH,
                 id: Optional[int] = None):
        self.id = next(IndexEntry._counter) if id is None else id
        self.url = url
        self.title = title
        self.content = content[:max_content_length] if content else ""
        now = datetime.now(timezone.utc)
        self.created_at = now
        self.updated_at = now

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "url": self.url,
            "title": self.title,
            "content": self.content,
            "created_at": self.created_at.isoformat(),
            "updated_at": self.updated_at.isoformat(),
        }

    @classmethod
    def reset_counter(cls) -> None:
        cls._counter = itertools.count(1)


def clean_text(text: str) -> str:
    """Normalize extracted text (reference ``clean_text``, ``:219-232``)."""
    text = re.sub(r"\b(menu|html|title|include|nav|header|footer)\b", "", text,
                  flags=re.IGNORECASE)
    text = re.sub(r"[^\w\s\.\!\?-]", " ", text)
    text = re.sub(r"-+", " ", text)
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"\.+", ".", text)
    return text.strip()


class HtmlIngestor:
    def __init__(
        self,
        output_dir: str | Path = "data",
        url_prefix: str = "",
        max_content_length: int = DEFAULT_MAX_CONTENT_LENGTH,
        max_sentences: int = DEFAULT_MAX_SENTENCES,
    ):
        self.output_dir = Path(output_dir).resolve()
        self.url_prefix = url_prefix.rstrip("/")
        self.max_content_length = max_content_length
        self.max_sentences = max_sentences

    # ------------------------------------------------------------- extract
    def extract_text_from_html(self, soup: Union[Element, str]) -> str:
        """Reference ``extract_text_from_html`` semantics (``:144-165``) on a
        ``parse_html`` tree (or the markup, parsed here). Detaches the
        ``pre``, chrome and script elements from the tree it is given."""
        if isinstance(soup, str):
            soup = parse_html(soup)
        pre_contents = [tag.extract() for tag in soup.find_all("pre")]
        for element in soup.find_all(["script", "style", "nav", "footer", "header"]):
            element.decompose()
        content_areas = soup.find_all(["main", "article", "section"])
        if content_areas:
            text = " ".join(
                area.get_text(separator=" ", strip=True) for area in content_areas
            )
        else:
            text = soup.get_text(separator=" ", strip=True)
        pre_texts = "\n".join(pre.get_text() for pre in pre_contents)
        return f"{text}\n{pre_texts}" if pre_texts else text

    # ----------------------------------------------------------- summarize
    def extract_key_sentences(self, text: str) -> List[str]:
        """Position+length heuristic with near-duplicate suppression
        (reference ``extract_key_sentences``, ``:111-142``; spaCy vector
        similarity replaced by TF cosine)."""
        sentences = sentence_split(text)
        if not sentences:
            return []
        key: List[str] = []
        key_vecs = []
        if len(sentences[0].split()) >= 3:
            key.append(sentences[0])
            key_vecs.append(tf_vector(sentences[0]))
        for sent in sentences[1:]:
            if len(sent.split()) < 3:
                continue
            vec = tf_vector(sent)
            if key_vecs and any(
                cosine_sim(vec, kv) > _SIMILARITY_DEDUP for kv in key_vecs
            ):
                continue
            key.append(sent)
            key_vecs.append(vec)
            if len(key) >= self.max_sentences:
                break
        return key

    def summarize_text(self, text: str) -> str:
        """Reference ``summarize_text`` (``:167-188``)."""
        if not text.strip():
            return ""
        summary = " ".join(self.extract_key_sentences(text))
        if len(summary) > self.max_content_length:
            summary = summary[: self.max_content_length]
            last_period = summary.rfind(".")
            if last_period > 0:
                summary = summary[: last_period + 1]
        return summary.strip()

    # -------------------------------------------------------------- files
    def process_html_file(self, file_path: Path, root: Path) -> Optional[IndexEntry]:
        """One page's entry, or None (logged) for a page that cannot be read
        or holds no text."""
        try:
            with open(file_path, "r", encoding="utf-8") as f:
                soup = parse_html(f.read())
            text = clean_text(self.extract_text_from_html(soup))
            if not text:
                logger.warning("skipping %s: no meaningful content", file_path)
                return None
            content = self.summarize_text(text)
            rel = file_path.relative_to(root)
            url = f"{self.url_prefix}/{rel}" if self.url_prefix else str(rel)
            return IndexEntry(
                url=url.strip(),
                title=file_path.name,
                content=content,
                max_content_length=self.max_content_length,
            )
        except Exception as e:
            logger.error("error processing %s: %s", file_path, e)
            return None

    def generate_index(self, root: str | Path = ".") -> List[dict]:
        """Walk HTML files, summarize, write documents.json
        (reference ``generate_index``, ``:257-287``)."""
        root = Path(root).resolve()
        html_files = sorted(
            p for p in root.rglob("*.html")
            if p.name != "index.html" and self.output_dir not in p.parents
        )
        if not html_files:
            logger.warning("no HTML files found under %s", root)
            return []
        logger.info("found %d HTML files to process", len(html_files))
        with ThreadPoolExecutor() as executor:
            entries = list(
                filter(None, executor.map(
                    lambda p: self.process_html_file(p, root), html_files
                ))
            )
        # executor.map keeps input order: number the surviving entries 1..n
        for i, e in enumerate(entries, start=1):
            e.id = i
        valid = [
            e.to_dict() for e in entries if e.url and e.title and e.content
        ]
        if not valid:
            logger.error("no valid entries generated")
            return []
        self.write_index_file(valid)
        return valid

    def write_index_file(self, entries: List[dict]) -> None:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        out = self.output_dir / "documents.json"
        out.write_text(json.dumps(entries, indent=2, ensure_ascii=False))
        logger.info("wrote %s with %d entries", out, len(entries))
