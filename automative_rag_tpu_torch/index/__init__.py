from .filters import FilterError, FilterSpec, MetadataColumns, compile_filter
from .flat import FlatIndex, SearchResult
from .sparse import SparseIndex

__all__ = [
    "FilterError",
    "FilterSpec",
    "MetadataColumns",
    "compile_filter",
    "FlatIndex",
    "SearchResult",
    "SparseIndex",
]
