"""The port's HTML / JSON ingest against the JAX package's, on the CPU.

``tests/test_ingest.py``'s thirteen cases, run on the port's modules and
held to the JAX ones on the same inputs. The port's HTML extractor parses
with the standard library's ``HTMLParser`` where the JAX one uses
BeautifulSoup: its text must equal the JAX extractor's on bs4, byte for
byte, on every page of ``examples/corpus/``, on crafted pages (nested
content areas, ``<pre>`` inside them, comments, doctype, ``<template>``,
entities, void and unclosed tags) and on generated tag trees.
"""

import json
import logging
from concurrent.futures import ThreadPoolExecutor

import pytest
from bs4 import BeautifulSoup
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rag_faiss_embedding_tpu.ingest import DocumentValidator as JValidator
from rag_faiss_embedding_tpu.ingest import HtmlIngestor as JIngestor
from rag_faiss_embedding_tpu.ingest.html import clean_text as jclean_text
from rag_faiss_embedding_tpu.utils.text import sentence_split as jsentence_split
from rag_faiss_embedding_tpu_torch.ingest import DocumentValidator, HtmlIngestor, IndexEntry
from rag_faiss_embedding_tpu_torch.ingest.html import clean_text, parse_html
from rag_faiss_embedding_tpu_torch.utils.text import sentence_split

from .test_torch_slice import REPO

HTML = """<html><head><title>Page</title>
<script>var x = 1;</script><style>.a{}</style></head>
<body><nav>Skip me</nav><header>Skip header</header>
<main><p>JAX is a numerical computing library. It compiles programs with XLA.
JAX is a numerical computing library for accelerators.</p></main>
<pre>code block preserved</pre>
<footer>Skip footer</footer></body></html>"""

CRAFTED = {
    "nested_areas": "<main>intro <section>inner <article>deep</article></section> tail</main>"
                    "<section>second</section>",
    "pre_in_area": "<main><p>text</p><pre>  keep\n\tspaces  <b>bold</b>\n</pre>after</main>",
    "nested_pre": "<p>a<pre>1<pre>2</pre>3</pre>b</p>",
    "comments_doctype_pi": "<!DOCTYPE html><!-- top --><?xml version='1.0'?><body>"
                           "a<!-- in -->b<!---->c<![CDATA[cdata text]]></body>",
    "template_ruby": "<article>x<template><p>hidden</p></template>y<ruby>k"
                     "<rt>kana</rt><rp>(</rp></ruby></article>",
    "entities": "<p>&amp; &lt;&gt; &copy &nosuch; &#65;&#x42;&#X43; &#150;&#129; &#0; "
                "&#xD800; &#x110000; &amp&lt x &#38;amp;</p>",
    "void_and_unclosed": "<body><p>one<br>two</br><img src=a>three</img><hr/>"
                         "<div>open<span>inner</p>after<li>x<li>y</body>",
    "unmatched_end_tags": "</div>lead</section><main>m</main></b>trail</main>z",
    "chrome_inside_areas": "<main>keep<nav>drop</nav><header><section>gone</section>"
                           "</header><script>var s</script><style>p{}</style>end</main>",
    "chrome_with_pre": "<nav><pre>pre in nav</pre></nav><footer>f</footer>body text",
    "no_areas": "<html><body><div>plain <b>body</b> text</div>\n\n  <p> spaced </p></body></html>",
    "whitespace_only": "<body>  \n <main> \t </main>\n</body>",
    "empty": "",
    "deep_unclosed": "<div>" * 2000 + "bottom",
    "script_cdata_mode": "<script>if (a < b && c > d) { x = '</p>'; }</script>after",
    "textarea_and_title": "<title>T &amp; t</title><textarea> raw <b> text </textarea>z",
    "attributes": "<a href='x' title=\"y &amp; z\" disabled>link</a><input value=v>tail",
    "uppercase_tags": "<MAIN>Up<SECTION>Case</SECTION></MAIN><PRE>P</PRE>",
}


def _bs4_text(markup: str) -> str:
    return JIngestor().extract_text_from_html(BeautifulSoup(markup, "html.parser"))


@pytest.fixture
def corpus_dir(tmp_path):
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "page1.html").write_text(HTML)
    (tmp_path / "site" / "page2.html").write_text(
        "<html><body><p>FAISS searches dense vectors efficiently. "
        "It supports exact and approximate indexes.</p></body></html>"
    )
    (tmp_path / "site" / "index.html").write_text("<html><body>skip</body></html>")
    return tmp_path


def _without_times(entries):
    return [{k: v for k, v in e.items() if k not in ("created_at", "updated_at")}
            for e in entries]


# --------------------------------------------------- tests/test_ingest.py
def test_sentence_split_abbreviations():
    text = "Dr. Smith arrived. He sat down. Then Mr. Jones left."
    s = sentence_split(text)
    assert len(s) == 3
    assert s == jsentence_split(text)


def test_clean_text_removes_html_words_and_specials():
    text = "The menu and nav bar! [with] *specials* -- and dots..."
    out = clean_text(text)
    assert "menu" not in out and "nav" not in out
    assert "[" not in out and "*" not in out
    assert "..." not in out
    assert out == jclean_text(text)


def test_extract_strips_chrome_preserves_pre(corpus_dir):
    ing = HtmlIngestor(output_dir=corpus_dir / "data")
    text = ing.extract_text_from_html(parse_html(HTML))
    assert "Skip me" not in text and "Skip header" not in text
    assert "Skip footer" not in text and "var x" not in text
    assert "code block preserved" in text
    assert "numerical computing" in text
    assert text == _bs4_text(HTML)


def test_summarize_dedups_similar_sentences():
    text = ("JAX is a numerical computing library. "
            "JAX is a numerical computing library for accelerators. "
            "SQLite is an embedded database engine.")
    key = HtmlIngestor(max_sentences=3).extract_key_sentences(text)
    assert len(key) == 2  # near-duplicate second sentence suppressed
    assert "SQLite" in key[1]
    assert key == JIngestor(max_sentences=3).extract_key_sentences(text)


def test_generate_index_writes_documents_json(corpus_dir):
    IndexEntry.reset_counter()
    ing = HtmlIngestor(output_dir=corpus_dir / "data", url_prefix="https://example.com")
    entries = ing.generate_index(root=corpus_dir)
    assert len(entries) == 2  # index.html skipped
    assert entries[0]["id"] == 1 and entries[1]["id"] == 2
    assert entries[0]["url"].startswith("https://example.com/site/")
    assert all(e["content"] for e in entries)
    on_disk = json.loads((corpus_dir / "data" / "documents.json").read_text())
    assert on_disk == entries
    jentries = JIngestor(output_dir=corpus_dir / "jdata",
                         url_prefix="https://example.com").generate_index(root=corpus_dir)
    assert _without_times(entries) == _without_times(jentries)


def test_content_length_cap(corpus_dir):
    entries = HtmlIngestor(output_dir=corpus_dir / "data",
                           max_content_length=50).generate_index(root=corpus_dir)
    assert all(len(e["content"]) <= 50 for e in entries)
    jentries = JIngestor(output_dir=corpus_dir / "jdata",
                         max_content_length=50).generate_index(root=corpus_dir)
    assert _without_times(entries) == _without_times(jentries)


GOOD_DOC = {
    "url": "example.com/page",
    "title": "  A   Title  ",
    "content": "This is a perfectly reasonable document with more than ten "
               "words of content. It has two sentences!",
}


def test_validate_document_cleans_fields():
    out = DocumentValidator().validate_document(GOOD_DOC)
    assert out["url"] == "https://example.com/page"
    assert out["title"] == "A Title"
    assert out["content"] == out["content"].lower()
    assert out["metadata"]["word_count"] >= 10
    assert out["metadata"]["summary"]
    assert out == JValidator().validate_document(GOOD_DOC)


def test_validate_rejects_short_and_missing():
    for v in (DocumentValidator(), JValidator()):
        assert v.validate_document({"url": "x.com", "title": "t", "content": "too short"}) is None
        assert v.validate_document({"title": "t", "content": "x " * 20}) is None
        assert v.validate_document({}) is None


def test_textrank_summary_picks_sentences():
    text = ("jax compiles programs. jax compiles programs quickly. "
            "databases store documents. vectors enable search. "
            "jax compiles numerical programs for accelerators.")
    v = DocumentValidator(summarization_method="textrank", max_summary_sentences=2)
    summary = v.summarize_text(text)
    assert 0 < len(sentence_split(summary)) <= 2
    j = JValidator(summarization_method="textrank", max_summary_sentences=2)
    assert (v.summarization_method, summary) == (j.summarization_method,
                                                 j.summarize_text(text))


def test_batch_validate_and_run(tmp_path):
    inp = tmp_path / "in.json"
    out = tmp_path / "out.json"
    inp.write_text(json.dumps([GOOD_DOC, {"url": "", "title": "", "content": ""}]))
    validated = DocumentValidator(default_input=inp, default_output=out).run(show_summary=False)
    assert len(validated) == 1
    assert json.loads(out.read_text()) == validated
    assert validated == JValidator(default_input=inp, default_output=tmp_path / "j.json").run(
        show_summary=False)


def test_index_entry_counter_thread_safe():
    """The reference's id counter races under ThreadPoolExecutor
    (process_unstructured_html.py:42-46,276-280); ours must not."""
    IndexEntry.reset_counter()

    def make(i):
        return IndexEntry(url=f"u{i}", title=f"t{i}", content="c").id

    with ThreadPoolExecutor(max_workers=16) as ex:
        ids = list(ex.map(make, range(500)))
    assert sorted(ids) == list(range(1, 501))  # no duplicates, no gaps


def test_validator_summary_stats_parity(capsys):
    """Stats rows match the reference's display_summary computations
    (document_validator.py:238-253), and the JAX package's rows."""
    raw = [
        {"url": "http://a.com/x", "title": "Doc A",
         "content": "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu"},
        {"url": "http://b.com/y", "title": "Doc B",
         "content": "one two three four five six seven eight nine ten "
                    "eleven twelve thirteen fourteen"},
    ]
    v = DocumentValidator(summarization_method="basic")
    docs = v.batch_validate_documents(raw)
    stats = dict(v.summary_stats(docs))
    assert stats["Total Documents"] == "2"
    assert stats["Unique URLs"] == "2"
    assert stats["Average Word Count"] == "13.0"
    assert stats["Shortest Document"] == "12"
    assert stats["Longest Document"] == "14"
    assert stats["Summarization Method"] == "basic"
    assert stats["Average Content Reduction"].endswith("%")
    j = JValidator(summarization_method="basic")
    assert v.summary_stats(docs) == j.summary_stats(j.batch_validate_documents(raw))
    # plain-text rendering, and the no-docs path
    v.display_summary(docs)
    v.display_summary([])
    out = capsys.readouterr().out
    assert "Average Word Count  13.0" in out and "Title: Doc A" in out
    assert "No valid documents to display" in out


def test_validator_summary_stats_empty():
    """summary_stats is public API: an empty validation run must return an
    empty-corpus table, not ZeroDivisionError."""
    rows = DocumentValidator().summary_stats([])
    assert ("Total Documents", "0") in rows
    assert rows == JValidator().summary_stats([])


# ------------------------------------------------- the extractor vs bs4
CORPUS = sorted((REPO / "examples" / "corpus").glob("*.html"))


@pytest.mark.parametrize("page", CORPUS, ids=[p.name for p in CORPUS])
def test_extractor_equals_bs4_on_the_corpus(page):
    markup = page.read_text(encoding="utf-8")
    text = HtmlIngestor().extract_text_from_html(markup)
    assert len(text) > 100
    assert text == _bs4_text(markup)


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_extractor_equals_bs4_on_crafted_pages(name):
    assert HtmlIngestor().extract_text_from_html(CRAFTED[name]) == _bs4_text(CRAFTED[name])


TAGS = ["main", "section", "article", "pre", "p", "div", "span", "b", "nav", "header",
        "footer", "script", "style", "template", "br", "img", "hr", "rt", "textarea", "li"]
WORDS = ["alpha", "beta", " gamma ", "\n", "  ", "&amp;", "&lt;", "&#65;", "&#x42;", "&copy",
         "&nosuch;", "<!-- c -->", "x y", "\t", "é", "&#150;"]


def _trees(depth: int):
    """Generated markup: nested elements, strings, unclosed and stray tags."""
    leaf = st.sampled_from(WORDS)
    if depth == 0:
        return leaf
    child = _trees(depth - 1)

    def element(args):
        tag, kids, close = args
        inner = "".join(kids)
        return f"<{tag}>{inner}" + (f"</{tag}>" if close else "")

    return st.one_of(
        leaf,
        st.tuples(st.sampled_from(TAGS), st.lists(child, max_size=4),
                  st.booleans()).map(element),
        st.sampled_from(TAGS).map(lambda t: f"</{t}>"),
    )


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_trees(4), max_size=6).map("".join))
def test_extractor_equals_bs4_on_generated_pages(markup):
    assert HtmlIngestor().extract_text_from_html(markup) == _bs4_text(markup)


def test_parse_tree_mirrors_bs4_structure():
    """Void elements take no children, an end tag closes up to its open
    twin, an unmatched one is dropped."""
    root = parse_html("<div><p>a<br>b<img>c</div>d</span>e")
    [div] = root.children[:1]
    assert [getattr(c, "name", str(c)) for c in root.children] == ["div", "d", "e"]
    [p] = div.children
    assert [getattr(c, "name", str(c)) for c in p.children] == ["a", "br", "b", "img", "c"]
    assert p.children[1].children == [] and p.children[3].children == []


def test_a_page_that_cannot_be_read_is_logged_and_skipped(tmp_path, caplog):
    (tmp_path / "good.html").write_text("<main>A page about vector search on cards.</main>")
    (tmp_path / "bad.html").write_bytes(b"<main>\xff\xfe not utf-8</main>")
    (tmp_path / "empty.html").write_text("<main> </main>")
    logger = logging.getLogger("rag_faiss_embedding_tpu_torch")  # does not propagate
    logger.addHandler(caplog.handler)
    try:
        entries = HtmlIngestor(output_dir=tmp_path / "data").generate_index(root=tmp_path)
    finally:
        logger.removeHandler(caplog.handler)
    assert [e["title"] for e in entries] == ["good.html"]
    assert "error processing" in caplog.text and "bad.html" in caplog.text
    assert "no meaningful content" in caplog.text
    jentries = JIngestor(output_dir=tmp_path / "jdata").generate_index(root=tmp_path)
    assert _without_times(entries) == _without_times(jentries)


def test_embed_summarizer_takes_the_ports_pipeline():
    """The "embed" method on the port's EmbeddingPipeline picks the same
    sentences as the JAX one on the same encoder weights."""
    from .test_torch_serve import _embedders

    jemb, temb = _embedders()
    text = ("Jax compiles array programs. Sqlite stores documents in a file. "
            "Tpus multiply matrices with a systolic array. Accelerators run "
            "numerical programs. Documents live in a single database file.")
    t = DocumentValidator(summarization_method="embed", max_summary_sentences=2,
                          embedder=temb)
    j = JValidator(summarization_method="embed", max_summary_sentences=2, embedder=jemb)
    assert t.summarization_method == "embed"
    summary = t.summarize_text(text)
    assert len(sentence_split(summary)) == 2
    assert summary == j.summarize_text(text)
