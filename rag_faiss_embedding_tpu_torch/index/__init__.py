from .flat import FlatIndex
from .ivf import IVFFlatIndex
from .pq import PQIndex
from .vector_store import VectorStore
from .faiss_import import import_faiss_index
