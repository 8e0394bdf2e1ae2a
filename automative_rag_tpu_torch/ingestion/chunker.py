"""Chinese-aware recursive text splitting.

Parity target: the reference chunks with a CJK-separator-aware
``RecursiveCharacterTextSplitter`` at size 1000 / overlap 200
(``settings.py:151-152``, ``enhanced_transcript_processor.py:618+``).
This is an independent implementation of the same recursive strategy:
try the coarsest separator first, recurse into oversized pieces with finer
separators, then merge pieces into chunks with overlap carry-over.
"""

from __future__ import annotations

from typing import List

# coarse → fine; includes CJK sentence punctuation
_SEPARATORS = ["\n\n", "\n", "。", "！", "？", "；", ". ", "! ", "? ", "，", ", ", " ", ""]


def _split_on(text: str, separator: str) -> List[str]:
    if separator == "":
        return list(text)
    parts = text.split(separator)
    # keep the separator attached to the preceding piece
    return [p + separator for p in parts[:-1] if p] + ([parts[-1]] if parts[-1] else [])


def _recursive_pieces(text: str, chunk_size: int, separators: List[str]) -> List[str]:
    if len(text) <= chunk_size:
        return [text]
    separator, rest = separators[0], separators[1:]
    pieces: List[str] = []
    for piece in _split_on(text, separator):
        if len(piece) <= chunk_size or not rest:
            pieces.append(piece)
        else:
            pieces.extend(_recursive_pieces(piece, chunk_size, rest))
    return pieces


def split_text(text: str, chunk_size: int = 1000, chunk_overlap: int = 200) -> List[str]:
    """Split into ≤chunk_size chunks with ~chunk_overlap carry-over."""
    text = text.strip()
    if not text:
        return []
    if len(text) <= chunk_size:
        return [text]

    pieces = _recursive_pieces(text, chunk_size, _SEPARATORS)
    chunks: List[str] = []
    current = ""
    for piece in pieces:
        if len(current) + len(piece) <= chunk_size:
            current += piece
            continue
        if current:
            chunks.append(current.strip())
            # overlap: keep the tail of the finished chunk
            current = current[-chunk_overlap:] if chunk_overlap > 0 else ""
        while len(piece) > chunk_size:  # pathological unsplittable run
            chunks.append(piece[:chunk_size])
            piece = piece[chunk_size - chunk_overlap :] if chunk_overlap > 0 else piece[chunk_size:]
        current += piece
    if current.strip():
        chunks.append(current.strip())
    return [c for c in chunks if c]
