"""C99-subset front end (paper §2.1 'Kernel Code'); a copy of
``repro.core.c_parser``.

Accepts exactly the paper's input language: variable/array declarations
(``const``/``restrict``-style qualifiers and signed-literal scalar
initializers are tolerated, so real-world kerncraft stencil files parse
unmodified) followed by a perfect loop nest whose innermost body holds
assignments over constants, scalars, and affine array references
(multi-dimensional ``a[j][i]`` or flattened ``a[j*N+i]`` syntax). Function
calls, ifs, pointer arithmetic and irregular accesses are rejected, as in
Kerncraft.

The paper's Listings 1 and 3 parse verbatim (see
``repro_torch/configs/stencils``).
"""
from __future__ import annotations

import functools
import re

import sympy

from .kernel_ir import Access, Array, FlopCount, Loop, LoopKernel, SourceSpan
from .kernel_ir import sympify_ids as _sympify_ids_raw

_TOKEN_RE = re.compile(r"""
    (?P<float>\d+\.\d*(?:[fF])?|\.\d+(?:[fF])?|\d+[fF])
  | (?P<int>\d+)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<op>\+=|-=|\*=|/=|\+\+|--|[-+*/=;,(){}\[\]<>])
  | (?P<ws>\s+)
""", re.VERBOSE)

_TYPES = {"double": 8, "float": 4}

# type qualifiers / storage classes real-world kerncraft stencil files carry;
# they do not change the analysis, so the parser skips them wherever a type
# may appear
_QUALIFIERS = {"const", "restrict", "__restrict__", "__restrict", "volatile",
               "static", "register"}


class ParseError(ValueError):
    pass


@functools.lru_cache(maxsize=8192)
def _sympify_ids(s: str) -> sympy.Expr:
    """sympify treating *every* identifier as a plain Symbol (otherwise
    names like ``N`` resolve to sympy built-ins).  Memoized: the same index
    strings recur across declarations, bodies, and repeated parses."""
    try:
        expr = _sympify_ids_raw(s)
    except (sympy.SympifyError, SyntaxError, TypeError) as e:
        raise ParseError(f"bad index expression {s!r}: {e}")
    return sympy.expand(expr)


def _blank(m: re.Match) -> str:
    # replace a comment with same-length whitespace, newlines kept, so
    # token offsets (and the line/col spans built from them) stay true
    return re.sub(r"\S", " ", m.group())


def _tokenize_spans(src: str) -> tuple[list[str], list[tuple[int, int]]]:
    """Tokenize, also returning each token's 1-based (line, col)."""
    src = re.sub(r"//[^\n]*", _blank, src)
    src = re.sub(r"/\*.*?\*/", _blank, src, flags=re.S)
    line_starts = [0]
    for i, ch in enumerate(src):
        if ch == "\n":
            line_starts.append(i + 1)
    toks: list[str] = []
    spans: list[tuple[int, int]] = []
    pos, line = 0, 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise ParseError(f"unexpected character {src[pos]!r} at {pos}")
        while line + 1 < len(line_starts) and line_starts[line + 1] <= pos:
            line += 1
        if m.lastgroup != "ws":
            toks.append(m.group())
            spans.append((line + 1, pos - line_starts[line] + 1))
        pos = m.end()
    return toks, spans


def _tokenize(src: str) -> list[str]:
    return _tokenize_spans(src)[0]


class _Parser:
    def __init__(self, toks: list[str],
                 spans: list[tuple[int, int]] | None = None,
                 source_path: str = ""):
        self.toks = toks
        self.spans = spans
        self.source_path = source_path
        self.i = 0

    # -- token helpers -------------------------------------------------
    def span(self, k: int = 0) -> SourceSpan | None:
        """Source span of the token ``k`` ahead of the cursor (None when
        the parser was built without position data)."""
        if not self.spans:
            return None
        j = min(self.i + k, len(self.spans) - 1)
        line, col = self.spans[j]
        return SourceSpan(line=line, col=col, path=self.source_path)

    def peek(self, k: int = 0) -> str | None:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of input")
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise ParseError(f"expected {tok!r}, got {t!r} (pos {self.i})")

    # -- expressions ---------------------------------------------------
    # Returns (flops, reads) where reads is a list of (name, idx_tuple) for
    # array refs; scalar reads are register-resident and not recorded.
    def parse_expr(self, arrays: dict[str, Array], scalars: set[str]):
        return self._add(arrays, scalars)

    def _add(self, arrays, scalars):
        f, r = self._mul(arrays, scalars)
        while self.peek() in ("+", "-"):
            self.next()
            f2, r2 = self._mul(arrays, scalars)
            f = f + f2 + FlopCount(add=1)
            r += r2
        return f, r

    def _mul(self, arrays, scalars):
        f, r = self._unary(arrays, scalars)
        while self.peek() in ("*", "/"):
            op = self.next()
            f2, r2 = self._unary(arrays, scalars)
            f = f + f2 + (FlopCount(mul=1) if op == "*" else FlopCount(div=1))
            r += r2
        return f, r

    def _unary(self, arrays, scalars):
        if self.peek() in ("+", "-"):
            self.next()  # unary sign: free (folded into add/sub)
            return self._unary(arrays, scalars)
        return self._atom(arrays, scalars)

    def _atom(self, arrays, scalars):
        t = self.peek()
        if t == "(":
            self.next()
            f, r = self._add(arrays, scalars)
            self.expect(")")
            return f, r
        sp = self.span()
        t = self.next()
        if re.fullmatch(r"\d+\.?\d*[fF]?|\.\d+[fF]?|\d+[fF]", t) or t.isdigit():
            return FlopCount(), []
        if not re.fullmatch(r"[A-Za-z_]\w*", t):
            raise ParseError(f"unexpected token {t!r} in expression")
        if self.peek() == "[":
            idx = []
            while self.peek() == "[":
                self.next()
                idx.append(self._index_expr())
                self.expect("]")
            if t not in arrays:
                raise ParseError(f"use of undeclared array {t!r}")
            if len(idx) != len(arrays[t].dims):
                # flattened syntax a[j*N+i] on a declared-flat array is fine;
                # otherwise dimensionality must match
                if len(arrays[t].dims) != 1:
                    raise ParseError(f"{t}: {len(idx)} subscripts for "
                                     f"{len(arrays[t].dims)}-D array")
            return FlopCount(), [(t, tuple(idx), sp)]
        if t in arrays:
            raise ParseError(f"array {t!r} used without subscript")
        return FlopCount(), []   # scalar read: register resident

    def _index_expr(self) -> sympy.Expr:
        """Collect tokens of one subscript (affine; validated via sympy)."""
        depth, parts = 0, []
        while True:
            t = self.peek()
            if t is None:
                raise ParseError("unterminated subscript")
            if t == "[":
                depth += 1
            elif t == "]":
                if depth == 0:
                    break
                depth -= 1
            parts.append(self.next())
        return _sympify_ids("".join(parts))


def parse_kernel(src: str, name: str = "kernel",
                 constants: dict[str, int] | None = None,
                 source_path: str = "") -> LoopKernel:
    """Parse a paper-style C99 kernel into a :class:`LoopKernel`.

    ``source_path`` (when the text came from a file) is recorded on the
    kernel and in every loop/access :class:`SourceSpan` so diagnostics
    can point at the offending source line.
    """
    toks, spans = _tokenize_spans(src)
    p = _Parser(toks, spans, source_path=source_path)
    arrays: dict[str, Array] = {}
    scalars: set[str] = set()
    dtype_bytes = 8

    # --- declarations -------------------------------------------------
    while p.peek() in _TYPES or p.peek() in _QUALIFIERS:
        while p.peek() in _QUALIFIERS:          # const double s; ...
            p.next()
        ty = p.next()
        if ty not in _TYPES:
            raise ParseError(f"expected type after qualifier, got {ty!r}")
        dtype = _TYPES[ty]
        while True:
            while p.peek() in _QUALIFIERS:      # double restrict a[...]; ...
                p.next()
            var = p.next()
            if p.peek() == "[":
                dims = []
                while p.peek() == "[":
                    p.next()
                    dims.append(p._index_expr())
                    p.expect("]")
                arrays[var] = Array(var, tuple(dims), dtype)
                dtype_bytes = dtype
            else:
                scalars.add(var)
                if p.peek() == "=":
                    # scalar initializer (e.g. ``const double s = -0.25;``):
                    # the value is register-resident setup, not kernel work —
                    # validate it is a (possibly signed) constant and move on
                    p.next()
                    parts = []
                    while p.peek() not in (",", ";", None):
                        parts.append(p.next())
                    init = "".join(parts)
                    num = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?[fF]?"
                    if not re.fullmatch(f"{num}(?:/{num})?", init):
                        raise ParseError(
                            f"unsupported initializer {init!r} for {var!r}")
            t = p.next()
            if t == ";":
                break
            if t != ",":
                raise ParseError(f"expected ',' or ';' in declaration, got {t!r}")

    # --- loop nest ------------------------------------------------------
    loops: list[Loop] = []
    while p.peek() == "for":
        loop_span = p.span()
        p.next()
        p.expect("(")
        while (p.peek() in ("int", "long", "unsigned", "size_t")
               or p.peek() in _QUALIFIERS):
            p.next()
        var = sympy.Symbol(p.next())
        p.expect("=")
        # collect start expr up to ';'
        parts = []
        while p.peek() != ";":
            parts.append(p.next())
        p.expect(";")
        start = _sympify_ids("".join(parts))
        # condition: var < expr  (or <=, tokenized as '<' then '=')
        cv = p.next()
        if cv != str(var):
            raise ParseError(f"loop condition must test {var}, got {cv!r}")
        cmp_op = p.next()
        if cmp_op == "<" and p.peek() == "=":
            p.next()
            cmp_op = "<="
        elif cmp_op != "<":
            raise ParseError(f"unsupported loop condition operator {cmp_op!r}")
        parts = []
        while p.peek() != ";":
            parts.append(p.next())
        p.expect(";")
        stop = _sympify_ids("".join(parts))
        if cmp_op == "<=":
            stop = stop + 1
        # increment: k++ | k+=c
        iv = p.next()
        if iv != str(var):
            raise ParseError("loop increment must update the loop variable")
        inc = p.next()
        if inc == "++":
            step = 1
        elif inc == "+=":
            step = int(p.next())
        else:
            raise ParseError(f"unsupported increment {inc!r}")
        p.expect(")")
        p.expect("{")
        loops.append(Loop(var, start, stop, step, span=loop_span))

    if not loops:
        raise ParseError("no loop nest found")

    # --- body statements ------------------------------------------------
    flops = FlopCount()
    reads: list[tuple[str, tuple, SourceSpan | None]] = []
    writes: list[tuple[str, tuple, SourceSpan | None]] = []
    while p.peek() not in ("}", None):
        lhs_span = p.span()
        t = p.next()
        if t in ("if", "while", "switch"):
            raise ParseError(f"{t!r} not allowed in kernel body (paper §2.1)")
        if not re.fullmatch(r"[A-Za-z_]\w*", t or ""):
            raise ParseError(f"unexpected token {t!r} in body")
        lhs_name = t
        lhs_idx = None
        if p.peek() == "[":
            idx = []
            while p.peek() == "[":
                p.next()
                idx.append(p._index_expr())
                p.expect("]")
            lhs_idx = tuple(idx)
        op = p.next()
        if op in ("+=", "-=", "*=", "/="):
            # a[i] += expr  implies read+write of a[i] and one add/mul
            if lhs_idx is not None:
                reads.append((lhs_name, lhs_idx, lhs_span))
            flops = flops + (FlopCount(add=1) if op in ("+=", "-=") else
                             FlopCount(mul=1) if op == "*=" else FlopCount(div=1))
        elif op != "=":
            raise ParseError(f"expected assignment, got {op!r}")
        f, r = p.parse_expr(arrays, scalars)
        p.expect(";")
        flops = flops + f
        reads += r
        if lhs_idx is not None:
            writes.append((lhs_name, lhs_idx, lhs_span))
        else:
            scalars.add(lhs_name)
    # close braces
    while p.peek() == "}":
        p.next()

    # --- build IR: dedupe identical refs (register reuse within one iter) --
    accesses: list[Access] = []
    seen: set[tuple] = set()
    for nm, idx, sp in reads:
        key = (nm, idx, False)
        if key in seen:
            continue
        seen.add(key)
        accesses.append(Access(arrays[nm], idx, is_write=False, span=sp))
    for nm, idx, sp in writes:
        key = (nm, idx, True)
        if key in seen:
            continue
        seen.add(key)
        accesses.append(Access(arrays[nm], idx, is_write=True, span=sp))

    return LoopKernel(loops=loops, accesses=accesses, flops=flops,
                      arrays=arrays, constants=dict(constants or {}),
                      dtype_bytes=dtype_bytes, name=name, source=src,
                      source_path=source_path)
