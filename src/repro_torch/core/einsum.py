"""Extended Einsum notation (TeAAL Section 2.2 / 3.1).

Parses statements such as::

    Z[m, n] = A[k, m] * B[k, n]
    T[k, m, n] = take(A[k, m], B[k, n], 1)
    O[q] = I[q+s] * F[s]
    Y1[k0] = E[0, k0] - T[k0]
    P1 = P0                       (whole-tensor copy)

An Einsum specifies (1) the tensors and their ranks, (2) an iteration
space (the Cartesian product of all legal index-variable values) and
(3) the computation at each point.  Reduction over index variables
absent from the output uses the cascade's ``add`` operator (semiring-
redefinable, e.g. ``min`` for SSSP).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------- #
# AST
# ---------------------------------------------------------------------- #


@dataclass(frozen=True)
class AffineIndex:
    """An affine index expression: sum(coeff_i * var_i) + const."""
    terms: Tuple[Tuple[str, int], ...]   # ((var, coeff), ...)
    const: int = 0

    @property
    def vars(self) -> Tuple[str, ...]:
        return tuple(v for v, _ in self.terms)

    @property
    def is_bare(self) -> bool:
        return (len(self.terms) == 1 and self.terms[0][1] == 1
                and self.const == 0)

    def evaluate(self, bindings: Dict[str, int]) -> int:
        return self.const + sum(c * bindings[v] for v, c in self.terms)

    def __str__(self) -> str:
        parts = []
        for v, c in self.terms:
            parts.append(v if c == 1 else f"{c}{v}")
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts)


@dataclass(frozen=True)
class TensorAccess:
    tensor: str
    indices: Tuple[AffineIndex, ...]

    @property
    def vars(self) -> Tuple[str, ...]:
        out: List[str] = []
        for idx in self.indices:
            for v in idx.vars:
                if v not in out:
                    out.append(v)
        return tuple(out)

    def __str__(self) -> str:
        return f"{self.tensor}[{', '.join(map(str, self.indices))}]"


@dataclass(frozen=True)
class Take:
    """take(a, b, which): 0 if either input is 0, else input ``which``."""
    args: Tuple["Expr", ...]
    which: int

    @property
    def vars(self) -> Tuple[str, ...]:
        out: List[str] = []
        for a in self.args:
            for v in expr_vars(a):
                if v not in out:
                    out.append(v)
        return tuple(out)

    def __str__(self) -> str:
        return f"take({', '.join(map(str, self.args))}, {self.which})"


@dataclass(frozen=True)
class BinOp:
    op: str                     # '*', '+', '-'
    lhs: "Expr"
    rhs: "Expr"

    def __str__(self) -> str:
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclass(frozen=True)
class Literal:
    value: float

    def __str__(self) -> str:
        return str(self.value)


Expr = Any  # TensorAccess | Take | BinOp | Literal


def expr_vars(expr: Expr) -> Tuple[str, ...]:
    if isinstance(expr, (TensorAccess, Take)):
        return expr.vars
    if isinstance(expr, BinOp):
        out = list(expr_vars(expr.lhs))
        for v in expr_vars(expr.rhs):
            if v not in out:
                out.append(v)
        return tuple(out)
    return ()


def expr_accesses(expr: Expr) -> List[TensorAccess]:
    if isinstance(expr, TensorAccess):
        return [expr]
    if isinstance(expr, Take):
        out: List[TensorAccess] = []
        for a in expr.args:
            out.extend(expr_accesses(a))
        return out
    if isinstance(expr, BinOp):
        return expr_accesses(expr.lhs) + expr_accesses(expr.rhs)
    return []


@dataclass
class Einsum:
    """One mapped-Einsum statement: output access, RHS expression."""
    output: TensorAccess
    expr: Expr
    text: str = ""

    @property
    def out_vars(self) -> Tuple[str, ...]:
        return self.output.vars

    @property
    def in_vars(self) -> Tuple[str, ...]:
        return expr_vars(self.expr)

    @property
    def all_vars(self) -> Tuple[str, ...]:
        out = list(self.out_vars)
        for v in self.in_vars:
            if v not in out:
                out.append(v)
        return tuple(out)

    @property
    def reduced_vars(self) -> Tuple[str, ...]:
        return tuple(v for v in self.in_vars if v not in self.out_vars)

    @property
    def inputs(self) -> List[TensorAccess]:
        return expr_accesses(self.expr)

    @property
    def input_names(self) -> List[str]:
        seen: List[str] = []
        for a in self.inputs:
            if a.tensor not in seen:
                seen.append(a.tensor)
        return seen

    def __str__(self) -> str:
        return self.text or f"{self.output} = {self.expr}"


# ---------------------------------------------------------------------- #
# Parser
# ---------------------------------------------------------------------- #
_TOKEN_RE = re.compile(
    r"\s*(?:(?P<name>[A-Za-z_][A-Za-z_0-9]*)|(?P<num>\d+(?:\.\d+)?)"
    r"|(?P<sym>[\[\](),+\-*=]))")


class _Tokens:
    def __init__(self, text: str):
        self.toks: List[Tuple[str, str]] = []
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m or m.end() == pos:
                if text[pos:].strip():
                    raise SyntaxError(f"bad einsum token at: {text[pos:]!r}")
                break
            pos = m.end()
            for kind in ("name", "num", "sym"):
                if m.group(kind) is not None:
                    self.toks.append((kind, m.group(kind)))
                    break
        self.i = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise SyntaxError("unexpected end of einsum")
        self.i += 1
        return tok

    def expect(self, value: str) -> None:
        kind, v = self.next()
        if v != value:
            raise SyntaxError(f"expected {value!r}, got {v!r}")


def parse_einsum(text: str) -> Einsum:
    """Parse one statement ``LHS = RHS``.

    Memoized: parsing is a pure function of ``text`` and every AST
    node is a frozen dataclass, so specs built from the same
    expression share one parse.  Design-space sweeps rebuild specs
    per point and this dominates spec-construction cost otherwise.
    """
    cached = _PARSE_CACHE.get(text)
    if cached is None:
        lhs_text, rhs_text = text.split("=", 1)
        output = _parse_access(lhs_text.strip())
        expr = _parse_expr(_Tokens(rhs_text.strip()))
        cached = Einsum(output=output, expr=expr, text=text.strip())
        if len(_PARSE_CACHE) >= 4096:
            _PARSE_CACHE.clear()
        _PARSE_CACHE[text] = cached
    return cached


_PARSE_CACHE: Dict[str, Einsum] = {}


def _parse_access(text: str) -> TensorAccess:
    toks = _Tokens(text)
    kind, name = toks.next()
    assert kind == "name"
    if toks.peek() is None:           # bare tensor: P1 = P0
        return TensorAccess(name, ())
    toks.expect("[")
    indices: List[AffineIndex] = []
    while True:
        indices.append(_parse_affine(toks))
        kind, v = toks.next()
        if v == "]":
            break
        assert v == ","
    return TensorAccess(name, tuple(indices))


def _parse_affine(toks: _Tokens) -> AffineIndex:
    terms: List[Tuple[str, int]] = []
    const = 0
    sign = 1
    while True:
        kind, v = toks.next()
        if kind == "num":
            nxt = toks.peek()
            if nxt and nxt[1] == "*":          # 2*p
                toks.next()
                kind2, var = toks.next()
                assert kind2 == "name"
                terms.append((var, sign * int(v)))
            else:
                const += sign * int(float(v))
        elif kind == "name":
            terms.append((v, sign))
        else:
            raise SyntaxError(f"bad index term {v!r}")
        nxt = toks.peek()
        if nxt and nxt[1] in "+-":
            sign = 1 if nxt[1] == "+" else -1
            toks.next()
            continue
        break
    return AffineIndex(tuple(terms), const)


def _parse_expr(toks: _Tokens) -> Expr:
    node = _parse_term(toks)
    while True:
        nxt = toks.peek()
        if nxt and nxt[1] in "+-":
            op = toks.next()[1]
            rhs = _parse_term(toks)
            node = BinOp(op, node, rhs)
        else:
            return node


def _parse_term(toks: _Tokens) -> Expr:
    node = _parse_factor(toks)
    while True:
        nxt = toks.peek()
        if nxt and nxt[1] == "*":
            toks.next()
            rhs = _parse_factor(toks)
            node = BinOp("*", node, rhs)
        else:
            return node


def _parse_factor(toks: _Tokens) -> Expr:
    kind, v = toks.next()
    if kind == "num":
        return Literal(float(v))
    if kind == "sym" and v == "(":
        node = _parse_expr(toks)
        toks.expect(")")
        return node
    assert kind == "name", f"unexpected {v!r}"
    if v == "take":
        toks.expect("(")
        args: List[Expr] = []
        while True:
            args.append(_parse_expr(toks))
            kind2, v2 = toks.next()
            if v2 == ")":
                break
            assert v2 == ","
        which_lit = args.pop()
        assert isinstance(which_lit, Literal), "take() needs literal selector"
        return Take(tuple(args), int(which_lit.value))
    nxt = toks.peek()
    if nxt and nxt[1] == "[":
        toks.next()
        indices: List[AffineIndex] = []
        while True:
            indices.append(_parse_affine(toks))
            kind2, v2 = toks.next()
            if v2 == "]":
                break
            assert v2 == ","
        return TensorAccess(v, tuple(indices))
    return TensorAccess(v, ())


# ---------------------------------------------------------------------- #
# Semirings and dense-oracle evaluation
# ---------------------------------------------------------------------- #
@dataclass
class Semiring:
    """Redefinable (+, *) pair (TeAAL Sec. 8: e.g. SSSP uses (min, +)).

    The scalar callables (`add`/`mul`/`sub`) drive the fibertree
    interpreter; the vectorized forms (`add_vec`/`mul_vec`/`sub_vec`)
    drive the columnar `VectorBackend`.  A semiring without vectorized
    forms (``add_vec is None``) is interpreter-only: the vector lowering
    raises `_Unsupported` and the cascade falls back to the oracle.

    `add_ufunc` is set only when ``ufunc.reduceat`` over a group is
    bit-identical to a sequential left fold of `add` (true for `min`,
    which is exact under any association; NOT true for float `np.add`,
    whose reduce uses pairwise summation).  `annihilator` is the value
    that means "empty payload" in the fibertree (0 for every semiring
    here); `is_idempotent` marks ``add(x, x) == x`` reductions, which
    the analytic backend's collision model exploits.
    """
    add: Callable[[Any, Any], Any] = lambda a, b: a + b
    mul: Callable[[Any, Any], Any] = lambda a, b: a * b
    sub: Callable[[Any, Any], Any] = lambda a, b: a - b
    add_identity: Any = 0.0
    name: str = "arith"
    add_vec: Optional[Callable[[Any, Any], Any]] = None
    mul_vec: Optional[Callable[[Any, Any], Any]] = None
    sub_vec: Optional[Callable[[Any, Any], Any]] = None
    add_ufunc: Optional[Any] = None      # segmented-reduceat-safe ufunc
    annihilator: float = 0.0
    is_idempotent: bool = False

    @property
    def has_vector_forms(self) -> bool:
        return (self.add_vec is not None and self.mul_vec is not None
                and self.sub_vec is not None)

    @staticmethod
    def arithmetic() -> "Semiring":
        # add_ufunc stays None: np.add.reduce pairwise-sums floats, which
        # is not bit-identical to the interpreter's sequential fold.
        return Semiring(add_vec=np.add, mul_vec=np.multiply,
                        sub_vec=np.subtract)

    @staticmethod
    def min_plus() -> "Semiring":
        """SSSP: reduce with min, combine with +.  The additive identity is
        +inf, and 'zero' (the annihilator / empty payload) stays 0 in the
        fibertree which callers must account for."""
        return Semiring(add=min, mul=lambda a, b: a + b,
                        sub=lambda a, b: a - b,
                        add_identity=float("inf"), name="min_plus",
                        add_vec=np.minimum, mul_vec=np.add,
                        sub_vec=np.subtract, add_ufunc=np.minimum,
                        is_idempotent=True)

    @staticmethod
    def or_and() -> "Semiring":
        """BFS frontier expansion: reduce with OR, combine with AND.

        No `add_ufunc`: a single-contribution group must keep its raw
        payload (the interpreter never calls `add` for it), which any
        boolean reduceat would collapse to 1.0."""
        return Semiring(add=lambda a, b: float(bool(a) or bool(b)),
                        mul=lambda a, b: float(bool(a) and bool(b)),
                        sub=lambda a, b: float(bool(a) and not bool(b)),
                        add_identity=0.0, name="or_and",
                        add_vec=lambda a, b: np.where(
                            (a != 0) | (b != 0), 1.0, 0.0),
                        mul_vec=lambda a, b: (
                            (a != 0) & (b != 0)).astype(np.float64),
                        sub_vec=lambda a, b: (
                            (a != 0) & (b == 0)).astype(np.float64),
                        is_idempotent=True)


def eval_expr_point(expr: Expr, bindings: Dict[str, int],
                    tensors: Dict[str, np.ndarray],
                    semiring: Semiring) -> float:
    """Evaluate the RHS expression at one iteration-space point (dense)."""
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, TensorAccess):
        arr = tensors[expr.tensor]
        idx = tuple(ix.evaluate(bindings) for ix in expr.indices)
        for d, (i, s) in enumerate(zip(idx, arr.shape)):
            if i < 0 or i >= s:
                return 0.0
        return float(arr[idx]) if idx else float(arr)
    if isinstance(expr, Take):
        vals = [eval_expr_point(a, bindings, tensors, semiring)
                for a in expr.args]
        if any(v == 0 for v in vals):
            return 0.0
        return vals[expr.which]
    if isinstance(expr, BinOp):
        lv = eval_expr_point(expr.lhs, bindings, tensors, semiring)
        rv = eval_expr_point(expr.rhs, bindings, tensors, semiring)
        if expr.op == "*":
            # semiring mul with annihilator 0 (empty payload)
            if lv == 0 or rv == 0:
                return 0.0
            return semiring.mul(lv, rv)
        if expr.op == "+":
            if lv == 0:
                return rv
            if rv == 0:
                return lv
            return semiring.add(lv, rv)
        if expr.op == "-":
            return semiring.sub(lv, rv)
    raise TypeError(f"bad expr {expr!r}")


def dense_reference(einsum: Einsum, tensors: Dict[str, np.ndarray],
                    shapes: Dict[str, int],
                    semiring: Optional[Semiring] = None) -> np.ndarray:
    """Dense oracle: brute-force the full iteration space.

    Intended for validation on small tensors; the fibertree path
    (repro_torch.core.generator) is the real evaluator.
    """
    semiring = semiring or Semiring.arithmetic()
    if not einsum.output.indices:        # bare copy: P1 = P0
        src = einsum.expr
        assert isinstance(src, TensorAccess)
        return np.array(tensors[src.tensor], copy=True)

    out_vars = list(einsum.out_vars)
    # one output dim per INDEX (constant indices -- e.g. E[0, k0] in the
    # FFT cascade -- still occupy a dimension); size = max value + 1
    max_bind = {v: shapes[v.upper()] - 1 for v in einsum.all_vars}
    out_shape = tuple(ix.evaluate(max_bind) + 1
                      for ix in einsum.output.indices)
    out = np.zeros(out_shape)
    filled = np.zeros(out_shape, dtype=bool)
    all_vars = list(einsum.all_vars)
    ranges = [range(shapes[v.upper()]) for v in all_vars]

    def rec(d: int, bindings: Dict[str, int]):
        if d == len(all_vars):
            val = eval_expr_point(einsum.expr, bindings, tensors, semiring)
            if val == 0:
                return
            oidx = tuple(ix.evaluate(bindings) for ix in einsum.output.indices)
            if any(i < 0 or i >= s for i, s in zip(oidx, out_shape)):
                return
            if filled[oidx]:
                out[oidx] = semiring.add(out[oidx], val)
            else:
                out[oidx] = val
                filled[oidx] = True
            return
        for val in ranges[d]:
            bindings[all_vars[d]] = val
            rec(d + 1, bindings)
        del bindings[all_vars[d]]

    rec(0, {})
    return out
