from .minilm import MiniLMConfig, MiniLMEncoder
from .tokenizer import WordPieceTokenizer
from .encoder import EmbeddingPipeline
