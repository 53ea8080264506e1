from .engine import QueryEngine
from .manager import RAGManager
