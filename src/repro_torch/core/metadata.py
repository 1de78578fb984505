"""Per-row metadata columns (counterpart of ``repro/core/metadata.py``;
DESIGN.md §8, format v9).

A ``MetaStore`` attaches named, typed columns to an index, row-aligned with
``MonaVec.ids`` (every segment's rows, tombstoned included, so positions
are stable across ``delete()``):

  * ``i64`` -- numpy int64 values, exact;
  * ``f64`` -- numpy float64 values, exact (NaN rejected, -0.0
    canonicalized to +0.0 so equality and ordering are total);
  * ``str`` -- small-enum interned strings: an index-global vocabulary per
    column plus int32 codes per row.

Exactness.  A predicate must give the same mask on the host
(``predicate.evaluate``, on the original values) and on the device (the
plan's mask stage).  Every column lowers once to an order- and
equality-preserving unsigned 64-bit key, as the reference's does:

  * i64 -> two's-complement bits with the sign bit flipped;
  * f64 -> the IEEE-754 total-order map (negatives -> ~bits, positives ->
    bits | 2^63), which keeps <, = and > exactly on non-NaN values;
  * str -> the non-negative vocabulary code (equality only).

The reference stores the key as two uint32 planes (``key_hi``/``key_lo``),
since JAX runs with x64 disabled.  The port stores ONE int64 plane per
column, ``skey = u64_key ^ 2^63`` read as a signed integer: flipping the top
bit maps unsigned order onto signed order, so PyTorch's int64 comparisons
(on the card and the CPU alike) reproduce the u64 comparison exactly.  For
an i64 column ``skey`` is the value itself; ``split_key`` of ``skey ^ 2^63``
gives the reference's two planes.  The device copy of each plane is made
once per column and device (``Column.on``); a column is rebuilt on every
append, gather or load, so a stale copy is never read.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

KIND_I64, KIND_F64, KIND_STR = "i64", "f64", "str"
KINDS = (KIND_I64, KIND_F64, KIND_STR)
_KIND_CODE = {KIND_I64: 0, KIND_F64: 1, KIND_STR: 2}
_KIND_NAME = {v: k for k, v in _KIND_CODE.items()}

_U64_MASK = (1 << 64) - 1
_SIGN = 1 << 63
#: u64 key guaranteed to equal no interned code (codes are int32 >= 0).
NO_MATCH_KEY = _U64_MASK


def kind_code(kind: str) -> int:
    return _KIND_CODE[kind]


def kind_name(code: int) -> str:
    if code not in _KIND_NAME:
        raise ValueError(f"unknown metadata column kind code {code}")
    return _KIND_NAME[code]


# ---------------------------------------------------------------------------
# Order-preserving u64 keys (host side, once per column version).
# ---------------------------------------------------------------------------

def _i64_keys(values: np.ndarray) -> np.ndarray:
    return values.view(np.uint64) ^ np.uint64(_SIGN)


def _f64_keys(values: np.ndarray) -> np.ndarray:
    bits = values.view(np.uint64)
    return np.where(bits >> np.uint64(63) != 0, ~bits, bits | np.uint64(_SIGN))


def signed_key(keys) -> np.ndarray:
    """u64 key(s) -> the int64 plane ``key ^ 2^63``: signed order on it is
    unsigned order on the keys."""
    k = np.asarray(keys, dtype=np.uint64) ^ np.uint64(_SIGN)
    return k.view(np.int64)


def encode_constant(kind: str, value, vocab: Optional[Dict[str, int]]) -> int:
    """Map one predicate constant through the column's key function.

    Returns a python int in [0, 2^64); out-of-vocabulary strings map to
    ``NO_MATCH_KEY`` so equality against them is False for every row.
    """
    if kind == KIND_I64:
        if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
            raise TypeError(f"i64 column constant must be an int, got {value!r}")
        v = int(value)
        if not (-(1 << 63) <= v < (1 << 63)):
            raise TypeError(f"i64 constant out of range: {value!r}")
        return (v & _U64_MASK) ^ _SIGN
    if kind == KIND_F64:
        if isinstance(value, bool) or not isinstance(
                value, (int, float, np.integer, np.floating)):
            raise TypeError(f"f64 column constant must be a number, got {value!r}")
        arr = np.asarray([value], dtype=np.float64)
        if np.isnan(arr[0]):
            raise TypeError("f64 column constant may not be NaN")
        arr[arr == 0.0] = 0.0          # -0.0 == +0.0: one canonical key
        return int(_f64_keys(arr)[0])
    if kind == KIND_STR:
        if not isinstance(value, str):
            raise TypeError(f"str column constant must be a string, got {value!r}")
        code = (vocab or {}).get(value)
        return NO_MATCH_KEY if code is None else code
    raise ValueError(f"unknown column kind {kind!r}")


def split_key(keys) -> Tuple[np.ndarray, np.ndarray]:
    """u64 key(s) -> (hi, lo) uint32 planes, the reference's device form."""
    k = np.asarray(keys, dtype=np.uint64)
    return ((k >> np.uint64(32)).astype(np.uint32),
            (k & np.uint64(0xFFFFFFFF)).astype(np.uint32))


# ---------------------------------------------------------------------------
# Columns and the store.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Column:
    """One typed column: exact host values and the int64 key plane."""

    kind: str
    values: np.ndarray                    # i64 / f64, or int32 codes for str
    vocab: Optional[List[str]] = None     # str columns: code -> string
    skey: np.ndarray = dataclasses.field(init=False)
    _on_device: dict = dataclasses.field(init=False, default_factory=dict, repr=False,
                                         compare=False)

    def __post_init__(self) -> None:
        if self.kind == KIND_I64:
            keys = _i64_keys(self.values)
        elif self.kind == KIND_F64:
            keys = _f64_keys(self.values)
        else:
            keys = self.values.astype(np.uint64)    # codes are >= 0
        self.skey = signed_key(keys)

    def on(self, device: torch.device) -> torch.Tensor:
        """The key plane as an int64 tensor on ``device``, copied there once."""
        if device not in self._on_device:
            self._on_device[device] = torch.from_numpy(self.skey.copy()).to(device)
        return self._on_device[device]

    @property
    def n(self) -> int:
        return int(self.values.shape[0])

    def vocab_map(self) -> Optional[Dict[str, int]]:
        return None if self.vocab is None else {s: i for i, s in enumerate(self.vocab)}


def _ingest(name: str, data, vocab: Optional[List[str]], kind: Optional[str]) -> Column:
    """Coerce one user-supplied column; kind inferred unless pinned."""
    arr = np.asarray(data)
    if arr.ndim != 1:
        raise ValueError(f"metadata column {name!r} must be 1-D, got shape {arr.shape}")
    if kind is None:
        if arr.dtype == bool or np.issubdtype(arr.dtype, np.integer):
            kind = KIND_I64
        elif np.issubdtype(arr.dtype, np.floating):
            kind = KIND_F64
        elif arr.dtype.kind in ("U", "O", "S"):
            kind = KIND_STR
        else:
            raise TypeError(f"metadata column {name!r}: cannot infer a kind from dtype "
                            f"{arr.dtype}")
    if kind == KIND_I64:
        if not (arr.dtype == bool or np.issubdtype(arr.dtype, np.integer)):
            raise TypeError(f"metadata column {name!r} is i64 but got dtype {arr.dtype}")
        return Column(kind=KIND_I64, values=arr.astype(np.int64))
    if kind == KIND_F64:
        if not np.issubdtype(arr.dtype, np.number) or arr.dtype == bool:
            raise TypeError(f"metadata column {name!r} is f64 but got dtype {arr.dtype}")
        vals = arr.astype(np.float64).copy()
        if np.isnan(vals).any():
            raise ValueError(f"metadata column {name!r} contains NaN "
                             "(unsupported: NaN breaks total ordering)")
        vals[vals == 0.0] = 0.0        # canonicalize -0.0
        return Column(kind=KIND_F64, values=vals)
    # str: intern against the (possibly pre-existing, index-global) vocabulary.
    voc = list(vocab) if vocab else []
    lut = {s: i for i, s in enumerate(voc)}
    codes = np.empty(arr.shape[0], dtype=np.int32)
    for i, v in enumerate(arr.tolist()):
        if not isinstance(v, str):
            raise TypeError(f"metadata column {name!r} is str but row {i} is {v!r}")
        code = lut.get(v)
        if code is None:
            code = lut[v] = len(voc)
            voc.append(v)
        codes[i] = code
    return Column(kind=KIND_STR, values=codes, vocab=voc)


@dataclasses.dataclass
class MetaStore:
    """Named typed columns, row-aligned with the index's concatenated rows."""

    columns: "collections.OrderedDict[str, Column]"

    @staticmethod
    def build(data: Mapping[str, Sequence], n_rows: int) -> "MetaStore":
        cols: "collections.OrderedDict[str, Column]" = collections.OrderedDict()
        for name in data:
            if not isinstance(name, str) or not name:
                raise ValueError(f"metadata column name must be a non-empty string, got "
                                 f"{name!r}")
            col = _ingest(name, data[name], vocab=None, kind=None)
            if col.n != n_rows:
                raise ValueError(f"metadata column {name!r} has {col.n} rows but the "
                                 f"index has {n_rows}")
            cols[name] = col
        return MetaStore(columns=cols)

    @property
    def n_rows(self) -> int:
        return next(iter(self.columns.values())).n if self.columns else 0

    @property
    def schema(self) -> Tuple[Tuple[str, str], ...]:
        """Ordered (name, kind) pairs."""
        return tuple((name, c.kind) for name, c in self.columns.items())

    def __bool__(self) -> bool:
        return bool(self.columns)

    def __getitem__(self, name: str) -> Column:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"unknown metadata column {name!r}; this index has "
                           f"{sorted(self.columns)}") from None

    def append(self, data: Mapping[str, Sequence], n_new: int) -> None:
        """Extend every column by one segment's rows (the ``add()`` path).

        The batch must supply exactly the schema's columns; every column is
        validated before any is changed.  Enum values not yet in a column's
        vocabulary extend it (codes are append-only, so existing rows never
        re-encode).
        """
        got, want = set(data), set(self.columns)
        if got != want:
            raise ValueError(f"add: metadata columns {sorted(got)} do not match the index "
                             f"schema {sorted(want)}")
        staged = {}
        for name, col in self.columns.items():
            new = _ingest(name, data[name], vocab=col.vocab, kind=col.kind)
            if new.n != n_new:
                raise ValueError(f"add: metadata column {name!r} has {new.n} rows, "
                                 f"expected {n_new}")
            staged[name] = new
        for name, col in self.columns.items():
            new = staged[name]
            self.columns[name] = Column(kind=col.kind,
                                        values=np.concatenate([col.values, new.values]),
                                        vocab=new.vocab if col.kind == KIND_STR else None)

    def gather(self, keep: np.ndarray) -> "MetaStore":
        """Row-select every column (``compact()`` carries columns through)."""
        cols: "collections.OrderedDict[str, Column]" = collections.OrderedDict()
        for name, c in self.columns.items():
            cols[name] = Column(kind=c.kind, values=c.values[keep],
                                vocab=None if c.vocab is None else list(c.vocab))
        return MetaStore(columns=cols)

    def slice(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Per-segment value blocks, for the v9 writer."""
        return {name: c.values[lo:hi] for name, c in self.columns.items()}
