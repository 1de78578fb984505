"""Structured predicates over metadata columns (counterpart of
``repro/core/predicate.py``; DESIGN.md §8).

A small AST -- ``Eq/Ne/Lt/Le/Gt/Ge/In`` over columns, composed with
``And/Or/Not`` (also ``&``, ``|``, ``~``) -- that the engine compiles into a
boolean mask stage ANDed into the live mask before every top-k:

    idx.search(q, 10, where=Eq("lang", "en") & Ge("date", 20260101))

Three views of one predicate, all agreeing:

  * ``evaluate(p, store)`` -- the host numpy oracle on the original values:
    the semantics.
  * ``structure(p, store)`` -- the predicate's shape (ops, column names and
    kinds, In-set sizes) without its constants.  It joins the plan key, so
    two predicates of one structure share one plan and one CUDA graph.
  * ``build_stage_fn(p)`` + ``flatten_args(p, store)`` -- the device form.
    The stage takes, per comparison leaf in preorder, the column's int64 key
    plane and the constant's key(s), and compares them as signed int64:
    the keys are order- and equality-preserving (``metadata.py``), so this
    is the host comparison exactly.  The constants are arguments mapped
    through the key function at call time, never values of the stage.

Ordering comparisons on ``str`` columns are rejected at validation: codes
are interning order, not collation order.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Tuple

import numpy as np
import torch

from .metadata import KIND_STR, MetaStore, NO_MATCH_KEY, encode_constant, signed_key


class Predicate:
    """Base: composable with ``&``, ``|``, ``~``."""

    def __and__(self, other: "Predicate") -> "Predicate":
        return And(self, other)

    def __or__(self, other: "Predicate") -> "Predicate":
        return Or(self, other)

    def __invert__(self) -> "Predicate":
        return Not(self)


@dataclasses.dataclass(frozen=True)
class _Cmp(Predicate):
    col: str
    value: object

    op = ""          # overridden

    def __str__(self) -> str:
        return f"{self.op}({self.col}, {self.value!r})"


class Eq(_Cmp):
    op = "eq"


class Ne(_Cmp):
    op = "ne"


class Lt(_Cmp):
    op = "lt"


class Le(_Cmp):
    op = "le"


class Gt(_Cmp):
    op = "gt"


class Ge(_Cmp):
    op = "ge"


@dataclasses.dataclass(frozen=True)
class In(Predicate):
    col: str
    values: tuple

    op = "in"

    def __post_init__(self) -> None:
        object.__setattr__(self, "values", tuple(self.values))
        if not self.values:
            raise ValueError("In() needs at least one value")


@dataclasses.dataclass(frozen=True)
class And(Predicate):
    lhs: Predicate
    rhs: Predicate


@dataclasses.dataclass(frozen=True)
class Or(Predicate):
    lhs: Predicate
    rhs: Predicate


@dataclasses.dataclass(frozen=True)
class Not(Predicate):
    inner: Predicate


_ORDERING = frozenset({"lt", "le", "gt", "ge"})


def _leaves(p: Predicate) -> Iterator[Predicate]:
    """Comparison leaves in preorder: the order of the stage's arguments."""
    if isinstance(p, (And, Or)):
        yield from _leaves(p.lhs)
        yield from _leaves(p.rhs)
    elif isinstance(p, Not):
        yield from _leaves(p.inner)
    else:
        yield p


def leaf_columns(p: Predicate) -> Tuple[str, ...]:
    """The column of each comparison leaf, in preorder."""
    return tuple(leaf.col for leaf in _leaves(p))


def validate(p: Predicate, store: MetaStore) -> None:
    """Check columns exist, ops suit their kinds and constants are typed
    right, raising before any plan work with the column and op named."""
    for leaf in _leaves(p):
        if not isinstance(leaf, (_Cmp, In)):
            raise TypeError(f"not a predicate node: {leaf!r}")
        col = store[leaf.col]
        if leaf.op in _ORDERING and col.kind == KIND_STR:
            raise TypeError(f"ordering comparison {leaf.op!r} is not defined on str "
                            f"column {leaf.col!r} (codes are interning order)")
        vocab = col.vocab_map()
        values = leaf.values if isinstance(leaf, In) else (leaf.value,)
        for v in values:
            encode_constant(col.kind, v, vocab)     # raises on a bad type


def structure(p: Predicate, store: MetaStore) -> tuple:
    """The predicate's shape without its constants (part of the plan key)."""
    if isinstance(p, And):
        return ("and", structure(p.lhs, store), structure(p.rhs, store))
    if isinstance(p, Or):
        return ("or", structure(p.lhs, store), structure(p.rhs, store))
    if isinstance(p, Not):
        return ("not", structure(p.inner, store))
    kind = store[p.col].kind
    if isinstance(p, In):
        return ("in", p.col, kind, len(p.values))    # the set's size is a shape
    return (p.op, p.col, kind)


def evaluate(p: Predicate, store: MetaStore) -> np.ndarray:
    """[n_rows] bool: the reference semantics every other path must match."""
    if isinstance(p, And):
        return evaluate(p.lhs, store) & evaluate(p.rhs, store)
    if isinstance(p, Or):
        return evaluate(p.lhs, store) | evaluate(p.rhs, store)
    if isinstance(p, Not):
        return ~evaluate(p.inner, store)
    col = store[p.col]
    vals = col.values
    if col.kind == KIND_STR:
        lut = col.vocab_map()
        if isinstance(p, In):
            codes = [lut.get(v, -1) for v in p.values]
            return np.isin(vals, np.asarray(codes, dtype=np.int64))
        code = lut.get(p.value, -1)
        hit = vals == code
        return ~hit if p.op == "ne" else hit
    if isinstance(p, In):
        return np.isin(vals, np.asarray(list(p.values), dtype=vals.dtype))
    c = vals.dtype.type(p.value)
    return {
        "eq": lambda: vals == c, "ne": lambda: vals != c,
        "lt": lambda: vals < c, "le": lambda: vals <= c,
        "gt": lambda: vals > c, "ge": lambda: vals >= c,
    }[p.op]()


# ---------------------------------------------------------------------------
# Device form: the stage and its per-call arguments.
# ---------------------------------------------------------------------------

_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


def build_stage_fn(p: Predicate) -> Callable[..., torch.Tensor]:
    """``fn(live, *args) -> live & mask``: pure boolean algebra over int64
    comparisons, no float arithmetic, so the mask is exact on any device.

    ``args`` are, per comparison leaf in preorder, the column's key plane
    [n] and the constant's key: a 0-d tensor, or [m] for ``In``.  An ``In``
    ORs one equality per value (m is part of the structure), so no [n, m]
    matrix is made.
    """
    def rec(node):
        if isinstance(node, And):
            fa, fb = rec(node.lhs), rec(node.rhs)
            return lambda it: fa(it) & fb(it)
        if isinstance(node, Or):
            fa, fb = rec(node.lhs), rec(node.rhs)
            return lambda it: fa(it) | fb(it)
        if isinstance(node, Not):
            fa = rec(node.inner)
            return lambda it: ~fa(it)
        if isinstance(node, In):
            m = len(node.values)

            def member(it):
                col, keys = next(it), next(it)
                hit = col == keys[0]
                for j in range(1, m):
                    hit |= col == keys[j]
                return hit
            return member
        cmp = _CMP[node.op]

        def leaf(it):
            col, key = next(it), next(it)
            return cmp(col, key)
        return leaf

    inner = rec(p)

    def fn(live: torch.Tensor, *args: torch.Tensor) -> torch.Tensor:
        return live & inner(iter(args))

    return fn


def constant_keys(p: Predicate, store: MetaStore) -> Tuple[np.ndarray, ...]:
    """Per leaf in preorder, the constant(s) mapped through the column's key
    function at call time: int64 0-d (a comparison) or [m] (``In``)."""
    out: List[np.ndarray] = []
    for leaf in _leaves(p):
        col = store[leaf.col]
        vocab = col.vocab_map()
        values = leaf.values if isinstance(leaf, In) else (leaf.value,)
        keys = signed_key(np.asarray([encode_constant(col.kind, v, vocab) for v in values],
                                     dtype=np.uint64))
        out.append(keys if isinstance(leaf, In) else keys.reshape(()))
    return tuple(out)


def flatten_args(p: Predicate, store: MetaStore) -> Tuple[np.ndarray, ...]:
    """The stage's operands in preorder, on the host: (column key plane,
    constant key) per leaf.  The engine binds the columns' device planes
    (``Column.on``) as index tensors and copies the constants into the
    CUDA graph's static inputs before each replay."""
    out: List[np.ndarray] = []
    for leaf, keys in zip(_leaves(p), constant_keys(p, store)):
        out.append(store[leaf.col].skey)
        out.append(keys)
    return tuple(out)


__all__ = [
    "Predicate", "Eq", "Ne", "Lt", "Le", "Gt", "Ge", "In", "And", "Or", "Not",
    "validate", "structure", "evaluate", "build_stage_fn", "constant_keys",
    "flatten_args", "leaf_columns", "NO_MATCH_KEY",
]
