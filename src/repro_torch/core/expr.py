"""Declarative column-expression DSL — introspectable predicates and
derived-column expressions whose provenance is DERIVED, not declared.

The legacy component API takes opaque Python lambdas plus a hand-declared
``reads=`` list; one forgotten column silently disables filter-commute,
segment fusion and the minimal device upload set.  This module replaces the
lambdas with a small expression AST:

    from repro_torch import col, lit, where

    pred = col("lo_discount").between(1, 3) & (col("d_year") == 1993)
    rev  = col("lo_extendedprice") * col("lo_discount")
    big  = where(col("profit") > 0, col("profit"), lit(0)).cast(np.int32)

Every node knows its exact read column set (``Expr.columns()``), so the
cost-based optimizer's commute/fusion rules and ``FusedSegment``'s kernel
upload set get exact provenance for free.

An ``Expr`` is *callable with the legacy signature* ``expr(cache, rows)``,
so it drops into every place a ``fn(cache, rows)`` lambda was accepted —
and because evaluation dispatches through the operands' own operators, the
same AST compiles three ways:

  1. **eager numpy** — ``cache.col`` returns host ndarrays, the ops run
     vectorized on host (the reference semantics);
  2. **eager torch** — the torch backend evaluates an expression over
     exactly ``columns()`` device tensors (``TorchBackend`` recognises
     ``Expr`` in ``filter_mask`` / ``eval_expression``), so predicates run
     on the device instead of a host lambda round-trip;
  3. **fused segment bodies** — inside ``Backend.compile_segment`` the
     segment runner hands the expression a ``SegmentEnv`` view over the
     segment's device columns.

Only ``where`` and dtype casts need explicit namespace dispatch (numpy vs
torch); everything else is plain operator protocol.
"""
from __future__ import annotations

import operator
from typing import Dict, FrozenSet, Iterable, List, Optional

import numpy as np
import torch

from .shared_cache import device_dtype


def _is_tensor(*values) -> bool:
    """True when any operand is a torch tensor (a device column)."""
    return any(isinstance(v, torch.Tensor) for v in values)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def cast(v, dtype):
    """``v.astype(dtype)`` for host arrays; for a tensor, a cast to the
    device form of ``dtype`` (64-bit narrowed, as the device columns are)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch_dtype(device_dtype(dtype)))
    if not hasattr(v, "astype"):       # python scalar literal
        v = np.asarray(v)
    return v.astype(dtype)


class ColumnsView:
    """Minimal cache-like evaluation target over a plain dict of columns —
    what ``Expr.eval_columns`` and the torch expression runner hand to
    ``evaluate`` (same ``col``/``names`` surface as ``SharedCache``)."""

    __slots__ = ("_cols",)

    def __init__(self, cols: Dict[str, object]):
        self._cols = cols

    @property
    def names(self) -> List[str]:
        return list(self._cols)

    def col(self, name: str):
        try:
            return self._cols[name]
        except KeyError:
            raise KeyError(f"expression reads unknown column {name!r}; "
                           f"available: {sorted(self._cols)}") from None


# ---------------------------------------------------------------------------
#  AST nodes
# ---------------------------------------------------------------------------
class Expr:
    """Base expression node.  Build with ``col``/``lit``/``where`` and the
    overloaded operators; evaluate with ``expr(cache, rows)`` (the legacy
    component-callable signature) or ``expr.eval_columns({...})``."""

    # --------------------------------------------------------- construction
    @staticmethod
    def wrap(value) -> "Expr":
        """Lift a scalar to ``Lit``; pass ``Expr`` nodes through."""
        return value if isinstance(value, Expr) else Lit(value)

    # arithmetic -----------------------------------------------------------
    def __add__(self, o):
        return BinOp("add", self, Expr.wrap(o))

    def __radd__(self, o):
        return BinOp("add", Expr.wrap(o), self)

    def __sub__(self, o):
        return BinOp("sub", self, Expr.wrap(o))

    def __rsub__(self, o):
        return BinOp("sub", Expr.wrap(o), self)

    def __mul__(self, o):
        return BinOp("mul", self, Expr.wrap(o))

    def __rmul__(self, o):
        return BinOp("mul", Expr.wrap(o), self)

    def __truediv__(self, o):
        return BinOp("truediv", self, Expr.wrap(o))

    def __rtruediv__(self, o):
        return BinOp("truediv", Expr.wrap(o), self)

    def __floordiv__(self, o):
        return BinOp("floordiv", self, Expr.wrap(o))

    def __rfloordiv__(self, o):
        return BinOp("floordiv", Expr.wrap(o), self)

    def __mod__(self, o):
        return BinOp("mod", self, Expr.wrap(o))

    def __rmod__(self, o):
        return BinOp("mod", Expr.wrap(o), self)

    def __neg__(self):
        return UnOp("neg", self)

    def __abs__(self):
        return UnOp("abs", self)

    # comparisons ----------------------------------------------------------
    def __eq__(self, o):                                    # type: ignore[override]
        return BinOp("eq", self, Expr.wrap(o))

    def __ne__(self, o):                                    # type: ignore[override]
        return BinOp("ne", self, Expr.wrap(o))

    def __lt__(self, o):
        return BinOp("lt", self, Expr.wrap(o))

    def __le__(self, o):
        return BinOp("le", self, Expr.wrap(o))

    def __gt__(self, o):
        return BinOp("gt", self, Expr.wrap(o))

    def __ge__(self, o):
        return BinOp("ge", self, Expr.wrap(o))

    # __eq__ is overloaded to BUILD nodes, so restore identity hashing —
    # expressions are compared structurally via repr, never via ==
    __hash__ = object.__hash__

    # boolean --------------------------------------------------------------
    def __and__(self, o):
        return BinOp("and", self, Expr.wrap(o))

    def __rand__(self, o):
        return BinOp("and", Expr.wrap(o), self)

    def __or__(self, o):
        return BinOp("or", self, Expr.wrap(o))

    def __ror__(self, o):
        return BinOp("or", Expr.wrap(o), self)

    def __xor__(self, o):
        return BinOp("xor", self, Expr.wrap(o))

    def __rxor__(self, o):
        return BinOp("xor", Expr.wrap(o), self)

    def __invert__(self):
        return UnOp("invert", self)

    def __bool__(self):
        raise TypeError(
            "an Expr has no truth value — use & | ~ for boolean logic "
            "(`and`/`or`/`not` cannot be overloaded) and == for equality "
            "nodes")

    # sugar ----------------------------------------------------------------
    def between(self, lo, hi) -> "Expr":
        """Inclusive band predicate: ``lo <= self <= hi``."""
        return (self >= lo) & (self <= hi)

    def isin(self, values: Iterable) -> "Expr":
        """Membership predicate: OR-fold of equality against each value."""
        vals = list(values)
        if not vals:
            raise ValueError("isin() needs at least one value")
        out: Expr = self == vals[0]
        for v in vals[1:]:
            out = out | (self == v)
        return out

    def cast(self, dtype) -> "Expr":
        """Dtype-aware cast (``astype`` alias).  Device backends apply their
        device dtype (64-bit narrows to 32-bit)."""
        return Cast(self, np.dtype(dtype))

    astype = cast

    # --------------------------------------------------------- introspection
    def columns(self) -> FrozenSet[str]:
        """The EXACT set of column names this expression reads — derived
        from the AST, cached, and consumed as provenance by the optimizer's
        commute/fusion rules and the fused-kernel upload sets."""
        got = self.__dict__.get("_columns_cache")
        if got is None:
            got = self.__dict__["_columns_cache"] = self._columns()
        return got

    def _columns(self) -> FrozenSet[str]:  # pragma: no cover — abstract
        raise NotImplementedError

    # ------------------------------------------------------------ evaluation
    def evaluate(self, cache, rows):  # pragma: no cover — abstract
        """Evaluate against any cache-like view (``col(name)`` ->  array).
        ``rows`` slices each leaf column, matching the legacy lambda
        convention ``c.col(name)[rows]``."""
        raise NotImplementedError

    def __call__(self, cache, rows):
        """Legacy component-callable signature ``fn(cache, rows)`` — an
        ``Expr`` drops in wherever a predicate/expression lambda was
        accepted."""
        return self.evaluate(cache, rows)

    def eval_columns(self, cols: Dict[str, object]):
        """Convenience: evaluate over a plain ``{name: array}`` dict."""
        return self.evaluate(ColumnsView(cols), slice(None))


class Col(Expr):
    """A named column reference — the AST leaf."""

    def __init__(self, name: str):
        if not isinstance(name, str) or not name:
            raise TypeError(f"column name must be a non-empty str, "
                            f"got {name!r}")
        self.name = name

    def _columns(self) -> FrozenSet[str]:
        return frozenset({self.name})

    def evaluate(self, cache, rows):
        return cache.col(self.name)[rows]

    def __repr__(self) -> str:
        return f"col({self.name!r})"


class Lit(Expr):
    """A scalar literal.  Arrays are rejected: a per-row constant column
    would silently desynchronize under filtering — derive it from a real
    column instead."""

    def __init__(self, value):
        if isinstance(value, Expr):
            raise TypeError("lit() of an Expr — pass the expression itself")
        if isinstance(value, np.ndarray) and value.ndim != 0:
            raise TypeError(
                "lit() takes scalars only; a per-row array literal cannot "
                "stay row-synchronized under filtering — add it as a source "
                "column or derive() it")
        self.value = value.item() if isinstance(value, np.ndarray) else value

    def _columns(self) -> FrozenSet[str]:
        return frozenset()

    def evaluate(self, cache, rows):
        return self.value

    def __repr__(self) -> str:
        return f"lit({self.value!r})"


_BIN_FNS = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "truediv": operator.truediv, "floordiv": operator.floordiv,
    "mod": operator.mod,
    "eq": operator.eq, "ne": operator.ne, "lt": operator.lt,
    "le": operator.le, "gt": operator.gt, "ge": operator.ge,
    "and": operator.and_, "or": operator.or_, "xor": operator.xor,
}
_BIN_SYMBOLS = {
    "add": "+", "sub": "-", "mul": "*", "truediv": "/", "floordiv": "//",
    "mod": "%", "eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
    "ge": ">=", "and": "&", "or": "|", "xor": "^",
}


class BinOp(Expr):
    """A binary operation — evaluation dispatches through the operands' own
    operator protocol, so host ndarrays and device tensors both work without
    branching."""

    def __init__(self, op: str, left: Expr, right: Expr):
        if op not in _BIN_FNS:
            raise ValueError(f"unknown binary op {op!r}")
        self.op = op
        self.left = left
        self.right = right

    def _columns(self) -> FrozenSet[str]:
        return self.left.columns() | self.right.columns()

    def evaluate(self, cache, rows):
        return _BIN_FNS[self.op](self.left.evaluate(cache, rows),
                                 self.right.evaluate(cache, rows))

    def __repr__(self) -> str:
        return f"({self.left!r} {_BIN_SYMBOLS[self.op]} {self.right!r})"


_UN_FNS = {"neg": operator.neg, "invert": operator.invert, "abs": abs}
_UN_SYMBOLS = {"neg": "-", "invert": "~", "abs": "abs"}


class UnOp(Expr):
    def __init__(self, op: str, operand: Expr):
        if op not in _UN_FNS:
            raise ValueError(f"unknown unary op {op!r}")
        self.op = op
        self.operand = operand

    def _columns(self) -> FrozenSet[str]:
        return self.operand.columns()

    def evaluate(self, cache, rows):
        return _UN_FNS[self.op](self.operand.evaluate(cache, rows))

    def __repr__(self) -> str:
        if self.op == "abs":
            return f"abs({self.operand!r})"
        return f"({_UN_SYMBOLS[self.op]}{self.operand!r})"


class Cast(Expr):
    """Dtype cast.  The target dtype is the HOST dtype; device tensors take
    its device form (64-bit -> 32-bit), the dtype an uploaded column of that
    host dtype would have."""

    def __init__(self, operand: Expr, dtype):
        self.operand = operand
        self.dtype = np.dtype(dtype)

    def _columns(self) -> FrozenSet[str]:
        return self.operand.columns()

    def evaluate(self, cache, rows):
        return cast(self.operand.evaluate(cache, rows), self.dtype)

    def __repr__(self) -> str:
        return f"{self.operand!r}.cast({self.dtype.name!r})"


class Where(Expr):
    """Elementwise conditional select — the only node needing an explicit
    numpy-vs-torch dispatch (there is no operator for ``where``)."""

    def __init__(self, cond: Expr, if_true: Expr, if_false: Expr):
        self.cond = cond
        self.if_true = if_true
        self.if_false = if_false

    def _columns(self) -> FrozenSet[str]:
        return (self.cond.columns() | self.if_true.columns()
                | self.if_false.columns())

    def evaluate(self, cache, rows):
        c = self.cond.evaluate(cache, rows)
        t = self.if_true.evaluate(cache, rows)
        f = self.if_false.evaluate(cache, rows)
        if _is_tensor(c, t, f):
            return torch.where(c, t, f)
        return np.where(c, t, f)

    def __repr__(self) -> str:
        return f"where({self.cond!r}, {self.if_true!r}, {self.if_false!r})"


# ---------------------------------------------------------------------------
#  Public constructors
# ---------------------------------------------------------------------------
def col(name: str) -> Col:
    """Reference a column by name: ``col("lo_discount")``."""
    return Col(name)


def lit(value) -> Lit:
    """Lift a scalar to an expression literal (usually implicit — bare
    scalars on either side of an operator are wrapped automatically)."""
    return Lit(value)


def where(cond, if_true, if_false) -> Where:
    """Elementwise select: ``where(col("p") > 0, col("p"), lit(0))``."""
    return Where(Expr.wrap(cond), Expr.wrap(if_true), Expr.wrap(if_false))


def expr_reads(fn) -> Optional[FrozenSet[str]]:
    """Exact read set of a component callable: derived for ``Expr`` nodes,
    ``None`` (unknown) for opaque legacy callables."""
    return fn.columns() if isinstance(fn, Expr) else None
