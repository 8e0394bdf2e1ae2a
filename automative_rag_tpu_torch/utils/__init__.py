from .unicode import decode_unicode_escapes, clean_unicode_escapes, safe_json_dumps
from .text import clean_text, extract_year_from_text, extract_metadata_from_text
from . import quality

__all__ = [
    "decode_unicode_escapes",
    "clean_unicode_escapes",
    "safe_json_dumps",
    "clean_text",
    "extract_year_from_text",
    "extract_metadata_from_text",
    "quality",
]
