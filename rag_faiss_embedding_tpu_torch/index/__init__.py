from .flat import FlatIndex
from .ivf import IVFFlatIndex
from .vector_store import VectorStore
