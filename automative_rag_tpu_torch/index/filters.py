"""Metadata filter DSL → bitmask predicate compiler (PyTorch).

Port of ``automative_rag_tpu/index/filters.py``. The ``{field: value |
[values] | year-int | {"gte", "lte"}}`` dict DSL compiles to a fixed-shape
``FilterSpec`` of tensors evaluated as a boolean mask over a columnar
metadata store:

- KEYWORD fields are dictionary-encoded per field (host-side vocab, int32
  code column; code 0 = value missing, codes start at 1).
- NUMERIC fields (``year``, ``ingestion_time``) are raw int32 columns with a
  MISSING sentinel.

A compiled spec has static shapes (MAX_CONDITIONS × MAX_TERMS), so one
evaluation serves every filter. Unknown values compile to code -1 which
matches no row ("no such value → empty result").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..documents.schema import INDEXED_KEYWORD_FIELDS, INDEXED_NUMERIC_FIELDS

MAX_CONDITIONS = 8
MAX_TERMS = 16

NUMERIC_MISSING = np.int32(-(2**31))

# condition kinds
KIND_INACTIVE = 0
KIND_KEYWORD_SET = 1  # keyword column code ∈ terms
KIND_NUMERIC_SET = 2  # numeric column value ∈ terms
KIND_NUMERIC_RANGE = 3  # lo <= numeric column value <= hi

_KW_INDEX = {name: i for i, name in enumerate(INDEXED_KEYWORD_FIELDS)}
_NUM_INDEX = {name: i for i, name in enumerate(INDEXED_NUMERIC_FIELDS)}


class FilterError(ValueError):
    """Raised when a filter dict cannot be compiled against the schema."""


class FilterSpec(NamedTuple):
    """Fixed-shape compiled filter (tensors on the search device)."""

    kind: torch.Tensor  # int32 [MAX_CONDITIONS]
    field: torch.Tensor  # int32 [MAX_CONDITIONS] — column index within its table
    terms: torch.Tensor  # int32 [MAX_CONDITIONS, MAX_TERMS]
    term_valid: torch.Tensor  # bool  [MAX_CONDITIONS, MAX_TERMS]
    lo: torch.Tensor  # int32 [MAX_CONDITIONS]
    hi: torch.Tensor  # int32 [MAX_CONDITIONS]

    @classmethod
    def match_all(cls, device) -> "FilterSpec":
        return _spec_from_numpy(
            np.zeros(MAX_CONDITIONS, np.int32),
            np.zeros(MAX_CONDITIONS, np.int32),
            np.zeros((MAX_CONDITIONS, MAX_TERMS), np.int32),
            np.zeros((MAX_CONDITIONS, MAX_TERMS), bool),
            np.zeros(MAX_CONDITIONS, np.int32),
            np.zeros(MAX_CONDITIONS, np.int32),
            device,
        )


def _spec_from_numpy(kind, field_idx, terms, term_valid, lo, hi, device
                     ) -> FilterSpec:
    return FilterSpec(*(torch.as_tensor(a, device=device) for a in
                        (kind, field_idx, terms, term_valid, lo, hi)))


@dataclass
class MetadataColumns:
    """Host-side columnar metadata store with per-field dictionary encoding.

    ``codes``/``numerics`` are numpy arrays sized to ``capacity``; rows beyond
    the live count are zero/missing and excluded by the index validity mask.
    """

    capacity: int = 0
    count: int = 0
    vocabs: Dict[str, Dict[str, int]] = field(
        default_factory=lambda: {name: {} for name in INDEXED_KEYWORD_FIELDS}
    )
    codes: np.ndarray = field(
        default_factory=lambda: np.zeros((len(INDEXED_KEYWORD_FIELDS), 0), np.int32)
    )
    numerics: np.ndarray = field(
        default_factory=lambda: np.full((len(INDEXED_NUMERIC_FIELDS), 0), NUMERIC_MISSING, np.int32)
    )

    def _grow(self, capacity: int) -> None:
        if capacity <= self.capacity:
            return
        new_codes = np.zeros((len(INDEXED_KEYWORD_FIELDS), capacity), np.int32)
        new_codes[:, : self.capacity] = self.codes
        new_nums = np.full((len(INDEXED_NUMERIC_FIELDS), capacity), NUMERIC_MISSING, np.int32)
        new_nums[:, : self.capacity] = self.numerics
        self.codes, self.numerics, self.capacity = new_codes, new_nums, capacity

    def _encode_keyword(self, name: str, value: Any) -> int:
        vocab = self.vocabs[name]
        key = str(value)
        code = vocab.get(key)
        if code is None:
            code = len(vocab) + 1  # 0 is reserved for "missing"
            vocab[key] = code
        return code

    def append_rows(self, metadatas: Sequence[Dict[str, Any]], capacity: int) -> None:
        """Append one row per metadata dict; grows storage to ``capacity``."""
        self._grow(capacity)
        for md in metadatas:
            row = self.count
            for name, fi in _KW_INDEX.items():
                value = md.get(name)
                if value is not None:
                    self.codes[fi, row] = self._encode_keyword(name, value)
            for name, fi in _NUM_INDEX.items():
                value = md.get(name)
                if value is not None:
                    try:
                        self.numerics[fi, row] = int(value)
                    except (TypeError, ValueError):
                        pass
            self.count += 1

    def lookup_code(self, name: str, value: Any) -> int:
        """Code for a keyword value; -1 if never seen (matches nothing)."""
        return self.vocabs[name].get(str(value), -1)


def compile_filter(
    metadata_filter: Optional[Dict[str, Any]],
    columns: MetadataColumns,
    device,
) -> FilterSpec:
    """Compile the dict DSL into a fixed-shape ``FilterSpec``.

    Semantics (matching reference ``vectorstore.py:216-276``):
      - ``field: value``       → equality (AND across fields)
      - ``field: [v1, v2]``    → OR over the list, AND with other fields
      - ``year: <int|float>``  → range gte=lte (numeric equality)
      - ``None`` values and empty lists are skipped.

    Raises ``FilterError`` for unknown fields or too many conditions/terms —
    the caller may fall back to unfiltered search (the reference falls back
    on Qdrant filter errors, ``vectorstore.py:195-213``).
    """
    kind = np.zeros(MAX_CONDITIONS, np.int32)
    field_idx = np.zeros(MAX_CONDITIONS, np.int32)
    terms = np.zeros((MAX_CONDITIONS, MAX_TERMS), np.int32)
    term_valid = np.zeros((MAX_CONDITIONS, MAX_TERMS), bool)
    lo = np.zeros(MAX_CONDITIONS, np.int32)
    hi = np.zeros(MAX_CONDITIONS, np.int32)

    if not metadata_filter:
        return FilterSpec.match_all(device)

    c = 0
    for name, value in metadata_filter.items():
        if value is None:
            continue
        if isinstance(value, dict):
            # explicit numeric range {"gte": a, "lte": b} (reference Qdrant
            # Range semantics, vectorstore.py:252-262); open ends default to
            # the int32 extremes
            if name not in _NUM_INDEX:
                raise FilterError(f"field {name!r} does not support range filters")
            unknown = set(value) - {"gte", "lte"}
            if unknown:
                raise FilterError(f"unsupported range keys {sorted(unknown)}")
            if c >= MAX_CONDITIONS:
                raise FilterError(f"filter has more than {MAX_CONDITIONS} conditions")
            kind[c] = KIND_NUMERIC_RANGE
            field_idx[c] = _NUM_INDEX[name]
            gte, lte = value.get("gte"), value.get("lte")  # explicit null = open
            lo[c] = int(gte) if gte is not None else -(2**31) + 1
            hi[c] = int(lte) if lte is not None else 2**31 - 1
            c += 1
            continue
        if isinstance(value, list):
            values: List[Any] = [v for v in value if v is not None]
            if not values:
                continue
        else:
            values = [value]

        if c >= MAX_CONDITIONS:
            raise FilterError(f"filter has more than {MAX_CONDITIONS} conditions")
        if len(values) > MAX_TERMS:
            raise FilterError(f"filter field {name!r} has more than {MAX_TERMS} terms")

        if name in _NUM_INDEX:
            field_idx[c] = _NUM_INDEX[name]
            if len(values) == 1 and not isinstance(value, list):
                # single numeric → gte/lte range (reference year semantics)
                kind[c] = KIND_NUMERIC_RANGE
                lo[c] = hi[c] = int(values[0])
            else:
                kind[c] = KIND_NUMERIC_SET
                for t, v in enumerate(values):
                    terms[c, t] = int(v)
                    term_valid[c, t] = True
        elif name in _KW_INDEX:
            field_idx[c] = _KW_INDEX[name]
            kind[c] = KIND_KEYWORD_SET
            for t, v in enumerate(values):
                terms[c, t] = columns.lookup_code(name, v)
                term_valid[c, t] = True
        else:
            raise FilterError(f"field {name!r} is not in the indexed metadata schema")
        c += 1

    return _spec_from_numpy(kind, field_idx, terms, term_valid, lo, hi, device)


def eval_filter_mask(
    codes: torch.Tensor,  # int32 [n_keyword_fields, N]
    numerics: torch.Tensor,  # int32 [n_numeric_fields, N]
    spec: FilterSpec,
) -> torch.Tensor:
    """Evaluate a compiled filter to a boolean row mask on the device.

    All MAX_CONDITIONS conditions evaluate at once ([C, N] membership and
    range tests, the kind selecting per condition), then AND over C — a
    fixed handful of launches whatever the filter, and no host sync."""
    n_kw, n_num = codes.shape[0], numerics.shape[0]
    field_idx = spec.field.long()
    kw_cols = codes[field_idx.clamp(0, n_kw - 1)]  # [C, N]
    num_cols = numerics[field_idx.clamp(0, n_num - 1)]  # [C, N]
    terms = spec.terms[:, None, :]
    valid = spec.term_valid[:, None, :]
    in_kw = ((kw_cols[:, :, None] == terms) & valid).any(-1)
    in_num = ((num_cols[:, :, None] == terms) & valid).any(-1)
    in_range = (num_cols >= spec.lo[:, None]) & (num_cols <= spec.hi[:, None])
    kind = spec.kind[:, None]
    cond = torch.where(
        kind == KIND_KEYWORD_SET,
        in_kw,
        torch.where(
            kind == KIND_NUMERIC_SET,
            in_num,
            torch.where(kind == KIND_NUMERIC_RANGE, in_range,
                        torch.ones_like(in_range)),
        ),
    )
    return cond.all(dim=0)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def eval_filter_mask_np(
    codes: np.ndarray,  # int32 [n_keyword_fields, N]
    numerics: np.ndarray,  # int32 [n_numeric_fields, N]
    spec: FilterSpec,
) -> np.ndarray:
    """Host (numpy) mirror of ``eval_filter_mask`` — for row sets small
    enough that a device round-trip costs more than the scan (the host
    tail, explicit row checks). Semantics identical by construction; pinned
    against the tensor version in tests."""
    kind_a = _host(spec.kind)
    field_a = _host(spec.field)
    terms_a = _host(spec.terms)
    tvalid_a = _host(spec.term_valid)
    lo_a, hi_a = _host(spec.lo), _host(spec.hi)
    n = codes.shape[1]
    mask = np.ones(n, bool)
    n_kw, n_num = codes.shape[0], numerics.shape[0]
    for c in range(MAX_CONDITIONS):
        kind = int(kind_a[c])
        if kind == KIND_INACTIVE:
            continue
        if kind == KIND_KEYWORD_SET:
            col = codes[min(max(int(field_a[c]), 0), n_kw - 1)]
            cond = ((col[:, None] == terms_a[c][None, :])
                    & tvalid_a[c][None, :]).any(-1)
        elif kind == KIND_NUMERIC_SET:
            col = numerics[min(max(int(field_a[c]), 0), n_num - 1)]
            cond = ((col[:, None] == terms_a[c][None, :])
                    & tvalid_a[c][None, :]).any(-1)
        else:  # KIND_NUMERIC_RANGE
            col = numerics[min(max(int(field_a[c]), 0), n_num - 1)]
            cond = (col >= lo_a[c]) & (col <= hi_a[c])
        mask &= cond
    return mask
