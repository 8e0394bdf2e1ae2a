from .tokenizer import HashTokenizer, load_tokenizer
from .encoder import EncoderConfig, TransformerEncoder, load_flax_params
from .bge_m3 import DenseEmbedder
from .colbert import ColBERTEncoder
from .sparse import SparseEncoder

__all__ = [
    "HashTokenizer",
    "load_tokenizer",
    "EncoderConfig",
    "TransformerEncoder",
    "load_flax_params",
    "DenseEmbedder",
    "ColBERTEncoder",
    "SparseEncoder",
]
