from .flat import FlatIndex
from .vector_store import VectorStore
