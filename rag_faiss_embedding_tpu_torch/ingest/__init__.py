from .html import HtmlIngestor, IndexEntry
from .validator import DocumentValidator
