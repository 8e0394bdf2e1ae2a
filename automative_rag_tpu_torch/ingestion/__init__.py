from .metadata import MetadataExtractor
from .chunker import split_text
from .transcript import TranscriptProcessor
from .text_processor import TextProcessor

__all__ = [
    "MetadataExtractor",
    "split_text",
    "TranscriptProcessor",
    "TextProcessor",
]
