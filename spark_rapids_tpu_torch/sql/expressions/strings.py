"""String expressions: the torch counterpart of
``spark_rapids_tpu/sql/expressions/strings.py``, over the byte-matrix
layout with the ops of ``ops/strings_ops.py``.  ``md5`` (the hand kernel
``csrc/md5.cu``), ``conv`` and ``format_number`` (from the shortest digits
of ``csrc/dtoa.cu``) run on the device, where the JAX package runs them per
row on the host.

Length, Substring, Reverse, instr and locate count characters (code
points).  Upper, Lower and InitCap map code points through case tables
(Spark's ``upper("é中ñ")`` is "É中Ñ"; the JAX package changes ASCII letters
only).  A LIKE pattern must be a literal; ``_`` and non-ASCII patterns
match by characters on the device.  translate's sets and a trim set must
be literals, as on the JAX package's device path (it runs others per row
on the host, and the port raises); non-ASCII sets map and trim code points
on the device.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import types as T
from ...columnar.column import DeviceColumn, bucket_width, scalar_column
from ...ops import cast_strings as CS
from ...ops import kernels as K
from ...ops import strings_ops as S
from .cast import cast_column
from .core import (BinaryExpression, Expression, Literal, UnaryExpression,
                   valid_and)

#: the widest string a growing op builds (JAX ``_MAX_STR_BYTES``)
_MAX_STR_BYTES = 1 << 14


def _str(chars, lens, validity) -> DeviceColumn:
    return DeviceColumn(T.STRING, chars, validity, lens)


def _string_literal(e: Expression, what: str) -> str:
    v = _lit_str(e)
    if v is None:
        raise NotImplementedError(f"{what} must be a string literal (the "
                                  "JAX package runs others per row on the "
                                  "host)")
    return v


def _int_literal(e: Expression) -> Optional[int]:
    if isinstance(e, Literal) and isinstance(e.value, int) and \
            not isinstance(e.value, bool):
        return e.value
    return None


def _lit_str(e: Expression) -> Optional[str]:
    if isinstance(e, Literal) and isinstance(e.value, str):
        return e.value
    return None


# ---------------------------------------------------------------------------
# Measures
# ---------------------------------------------------------------------------

class Length(UnaryExpression):
    """Characters of a string (Spark ``length``), bytes of a binary
    value."""

    @property
    def data_type(self):
        return T.INT

    def kernel(self, ctx, c):
        if isinstance(c.dtype, T.BinaryType):
            return DeviceColumn(T.INT, c.lengths.clone(), c.validity)
        return DeviceColumn(T.INT, S.utf8_char_count(c.data, c.lengths),
                            c.validity)


class OctetLength(UnaryExpression):
    @property
    def data_type(self):
        return T.INT

    def kernel(self, ctx, c):
        return DeviceColumn(T.INT, c.lengths.clone(), c.validity)


class BitLength(UnaryExpression):
    @property
    def data_type(self):
        return T.INT

    def kernel(self, ctx, c):
        return DeviceColumn(T.INT, c.lengths * 8, c.validity)


# ---------------------------------------------------------------------------
# Case
# ---------------------------------------------------------------------------

class _StringTransform(UnaryExpression):
    _fn = None

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c):
        chars, lens = type(self)._fn(c.data, c.lengths)
        return DeviceColumn(T.STRING, chars, c.validity, lens)


class Upper(_StringTransform):
    _fn = staticmethod(lambda c, n: S.case_map(c, n, "upper"))


class Lower(_StringTransform):
    _fn = staticmethod(lambda c, n: S.case_map(c, n, "lower"))


class InitCap(_StringTransform):
    _fn = staticmethod(lambda c, n: S.case_map(c, n, "initcap"))


class Reverse(_StringTransform):
    _fn = staticmethod(S.reverse_chars)


# ---------------------------------------------------------------------------
# Substrings
# ---------------------------------------------------------------------------

class Substring(Expression):
    """substring(str, pos[, len]) by characters (``substring_chars``)."""

    def __init__(self, child: Expression, pos: Expression,
                 length: Optional[Expression] = None):
        self.children = (child, pos) if length is None \
            else (child, pos, length)

    def with_children(self, children):
        return Substring(*children)

    @property
    def data_type(self):
        return self.children[0].data_type

    def kernel(self, ctx, c, p, ln=None):
        chars, lens = S.substring_chars(
            c.data, c.lengths, p.data.to(c.lengths.dtype),
            None if ln is None else ln.data)
        cols = (c, p) if ln is None else (c, p, ln)
        return DeviceColumn(c.dtype, chars, valid_and(*cols), lens)


class SubstringIndex(Expression):
    def __init__(self, child, delim, count):
        self.children = (child, delim, count)

    def with_children(self, children):
        return SubstringIndex(*children)

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c, d, n):
        chars, lens = S.substring_index_bytes(c.data, c.lengths, d.data,
                                              d.lengths, n.data)
        return _str(chars, lens, valid_and(c, d, n))


# ---------------------------------------------------------------------------
# Concatenation
# ---------------------------------------------------------------------------

def _out_width(n: int) -> int:
    return min(bucket_width(max(n, 1)), _MAX_STR_BYTES)


def _as_text(ctx, c: DeviceColumn) -> DeviceColumn:
    """An argument of concat or concat_ws as a string column: a NULL is a
    null string, another type is cast (Spark's implicit cast)."""
    if c.lengths is not None:
        return c
    return cast_column(ctx, c, T.STRING)


class Concat(Expression):
    """concat(a, b, ...): null if any input is null."""

    def __init__(self, *children):
        self.children = tuple(children)

    def with_children(self, children):
        return Concat(*children)

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, *cols):
        if not cols:
            return scalar_column(T.STRING, "", ctx.capacity, ctx.device)
        cols = [_as_text(ctx, c) for c in cols]
        chars, lens = S.concat_bytes(
            [(c.data, c.lengths) for c in cols],
            _out_width(sum(c.data.shape[1] for c in cols)))
        return _str(chars, lens, valid_and(*cols))


class ConcatWs(Expression):
    """concat_ws(sep, ...): null inputs are skipped; null only when the
    separator is."""

    def __init__(self, sep, *children):
        self.children = (sep,) + tuple(children)

    def with_children(self, children):
        return ConcatWs(*children)

    @property
    def data_type(self):
        return T.STRING

    @property
    def nullable(self):
        return self.children[0].nullable

    def kernel(self, ctx, sep, *cols):
        sep = _as_text(ctx, sep)
        cols = [_as_text(ctx, c) for c in cols]
        rows = sep.data.shape[0]
        width = sep.data.shape[1] * max(len(cols), 1) + sum(
            c.data.shape[1] for c in cols)
        pieces = []
        has_prev = torch.zeros(rows, dtype=torch.bool, device=ctx.device)
        for c in cols:
            v = c.validity
            pieces.append((sep.data, torch.where(has_prev & v, sep.lengths,
                                                 0)))
            pieces.append((c.data, torch.where(v, c.lengths, 0)))
            has_prev = has_prev | v
        if not pieces:
            pieces = [(sep.data, torch.zeros_like(sep.lengths))]
        chars, lens = S.concat_bytes(pieces, _out_width(width))
        return _str(chars, lens, sep.validity)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

class _StringPredicate(BinaryExpression):
    _fn = None

    @property
    def data_type(self):
        return T.BOOLEAN

    def kernel(self, ctx, a, b):
        r = type(self)._fn(a.data, a.lengths, b.data, b.lengths)
        return DeviceColumn(T.BOOLEAN, r, valid_and(a, b))


class Contains(_StringPredicate):
    _fn = staticmethod(S.contains_bytes)


class StartsWith(_StringPredicate):
    _fn = staticmethod(S.starts_with)


class EndsWith(_StringPredicate):
    _fn = staticmethod(S.ends_with)


class Like(BinaryExpression):
    """str LIKE pattern [ESCAPE escape]: ``%`` any characters, ``_`` one."""

    def __init__(self, left: Expression, right: Expression,
                 escape: str = "\\"):
        super().__init__(left, right)
        self.escape = escape

    def with_children(self, children):
        return Like(children[0], children[1], self.escape)

    @property
    def data_type(self):
        return T.BOOLEAN

    def _key_extras(self):
        return (self.escape,)

    def sql(self):
        return f"({self.children[0].sql()} LIKE {self.children[1].sql()})"

    def kernel(self, ctx, c, p):
        pat = _lit_str(self.children[1])
        if pat is None:
            raise NotImplementedError("LIKE with a pattern that is not a "
                                      "string literal")
        return DeviceColumn(T.BOOLEAN,
                            S.like_match(c.data, c.lengths, pat, self.escape),
                            valid_and(c, p))


class StringInstr(BinaryExpression):
    """instr(str, substr): the 1-based character position of the first
    occurrence, 0 where there is none."""

    @property
    def data_type(self):
        return T.INT

    def kernel(self, ctx, c, sub):
        bpos = S.find_bytes(c.data, c.lengths, sub.data, sub.lengths)
        cpos = S.byte_pos_to_char_pos(c.data, c.lengths, bpos)
        return DeviceColumn(T.INT, cpos + 1, valid_and(c, sub))


class StringLocate(Expression):
    """locate(substr, str[, start]): instr from a 1-based start
    character; a start below 1 gives 0."""

    def __init__(self, substr, strc, start=None):
        self.children = (substr, strc, Literal(1) if start is None
                         else start)

    def with_children(self, children):
        return StringLocate(*children)

    @property
    def data_type(self):
        return T.INT

    def kernel(self, ctx, sub, c, start):
        st = start.data.to(torch.int64)
        bstart = S.char_pos_to_byte_pos(c.data, c.lengths,
                                        st.clamp(min=1) - 1)
        bpos = S.find_bytes(c.data, c.lengths, sub.data, sub.lengths,
                            bstart)
        cpos = S.byte_pos_to_char_pos(c.data, c.lengths, bpos)
        res = torch.where(st > 0, cpos + 1, 0).to(torch.int32)
        return DeviceColumn(T.INT, res, valid_and(sub, c, start))


# ---------------------------------------------------------------------------
# Editing
# ---------------------------------------------------------------------------

class StringReplace(Expression):
    """replace(str, search[, replace]): every non-overlapping occurrence,
    left to right."""

    def __init__(self, child, search, replace):
        self.children = (child, search, replace)

    def with_children(self, children):
        return StringReplace(*children)

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c, s, r):
        ls, lr = _lit_str(self.children[1]), _lit_str(self.children[2])
        w = c.data.shape[1]
        if ls is not None and lr is not None and ls:
            bound = (w // len(ls.encode())) * len(lr.encode()) + w
        else:
            bound = w * max(1, r.data.shape[1])
        chars, lens = S.replace_bytes(c.data, c.lengths, s.data, s.lengths,
                                      r.data, r.lengths, _out_width(bound))
        return _str(chars, lens, valid_and(c, s, r))


class StringTranslate(Expression):
    """translate(str, from, to): each character of ``from`` to the
    character at its place in ``to``, deleted past its end; the first
    mapping of a character wins.  ASCII sets map bytes; other sets map the
    rows' code points on the device (the JAX package runs them per row on
    the host)."""

    def __init__(self, child, from_s, to_s):
        self.children = (child, from_s, to_s)

    def with_children(self, children):
        return StringTranslate(*children)

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c, f, t):
        fs = _string_literal(self.children[1], "translate's from-set")
        ts = _string_literal(self.children[2], "translate's to-set")
        mapping = {}
        for i, ch in enumerate(fs):
            mapping.setdefault(ord(ch), ord(ts[i]) if i < len(ts) else -1)
        if (fs + ts).isascii():
            lut = list(range(256))
            for k, v in mapping.items():
                lut[k] = v
            chars, lens = S.translate_bytes(
                c.data, c.lengths, torch.tensor(lut, dtype=torch.int64,
                                                device=ctx.device))
        else:
            keys = sorted(mapping)
            chars, lens = S.translate_code_points(
                c.data, c.lengths,
                torch.tensor(keys, dtype=torch.int32, device=ctx.device),
                torch.tensor([mapping[k] for k in keys], dtype=torch.int32,
                             device=ctx.device))
        return _str(chars, lens, valid_and(c, f, t))


class StringRepeat(BinaryExpression):
    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c, n):
        lit = _int_literal(self.children[1])
        most = lit if lit is not None else int(n.data.max()) \
            if n.data.numel() else 0
        chars, lens = S.repeat_bytes(
            c.data, c.lengths, n.data,
            _out_width(c.data.shape[1] * max(most, 0)))
        return _str(chars, lens, valid_and(c, n))


class _PadBase(Expression):
    _left = True

    def __init__(self, child, length, pad=None):
        self.children = (child, length, Literal(" ") if pad is None
                         else pad)

    def with_children(self, children):
        return type(self)(*children)

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c, ln, p):
        lit = _int_literal(self.children[1])
        most = lit if lit is not None else int(ln.data.max()) \
            if ln.data.numel() else 0
        # bytes: the string cut to ``most`` characters, or all of it and
        # ``most`` characters of the pad
        pad_lit = _lit_str(self.children[2])
        per_char = 4 if pad_lit is None else max(
            [len(ch.encode()) for ch in pad_lit] + [1])
        most = max(most, 1)
        bound = min(c.data.shape[1], 4 * most) + most * per_char
        chars, lens = S.pad_bytes(c.data, c.lengths, ln.data, p.data,
                                  p.lengths, _out_width(bound),
                                  left=self._left)
        return _str(chars, lens, valid_and(c, ln, p))


class StringLPad(_PadBase):
    _left = True


class StringRPad(_PadBase):
    _left = False


class _TrimBase(Expression):
    _left = True
    _right = True

    def __init__(self, child, trim_str=None):
        self.children = (child,) if trim_str is None else (child, trim_str)

    def with_children(self, children):
        return type(self)(*children)

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c, t=None):
        chars_set = " " if t is None else _string_literal(
            self.children[1], "a trim set")
        if chars_set.isascii():
            lut = torch.zeros(256, dtype=torch.bool)
            for ch in chars_set:
                lut[ord(ch)] = True
            chars, lens = S.trim_bytes(c.data, c.lengths, lut.to(ctx.device),
                                       left=self._left, right=self._right)
        else:
            chars, lens = S.trim_code_points(
                c.data, c.lengths,
                torch.tensor(sorted({ord(ch) for ch in chars_set}),
                             dtype=torch.int32, device=ctx.device),
                left=self._left, right=self._right)
        return _str(chars, lens, c.validity if t is None
                    else valid_and(c, t))


class StringTrim(_TrimBase):
    _left = _right = True


class StringTrimLeft(_TrimBase):
    _left, _right = True, False


class StringTrimRight(_TrimBase):
    _left, _right = False, True


# ---------------------------------------------------------------------------
# md5, conv, format_number (the JAX package's host tail, here on the device)
# ---------------------------------------------------------------------------

class Md5(UnaryExpression):
    """md5(str or binary): 32 lower-case hex characters."""

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c):
        chars = K.md5(c.data, c.lengths, c.validity)
        lens = torch.full_like(c.lengths, 32)
        return _str(chars, torch.where(c.validity, lens, 0), c.validity)


class Conv(Expression):
    """conv(num, from_base, to_base): Spark's NumberConverter
    (``ops/cast_strings.conv``); null where no digit parses or a base lies
    outside 2..36."""

    def __init__(self, num, from_base, to_base):
        self.children = (num, from_base, to_base)

    def with_children(self, children):
        return Conv(*children)

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, c, fb, tb):
        c = _as_text(ctx, c)
        chars, lens, valid = CS.conv(c.data, c.lengths, valid_and(c, fb, tb),
                                     fb.data, tb.data)
        return _str(chars, lens, valid)


class FormatNumber(BinaryExpression):
    """format_number(x, d): ``x`` rounded HALF_EVEN to ``d`` decimals with
    its thousands grouped, as Spark's ``java.text.DecimalFormat`` writes it
    (a float is widened to the double, as Spark does); null for ``d`` < 0.
    A double's digits are its shortest (``kernels.dtoa_shortest``), a tie
    in them rounded by the exact double, NaN and the infinities as Java
    writes them ("NaN", "∞")."""

    @property
    def data_type(self):
        return T.STRING

    def kernel(self, ctx, x, d):
        ft = self.children[0].data_type
        places = d.data.to(torch.int64)
        valid = valid_and(x, d) & (places >= 0)
        if T.is_integral(ft):
            mat, lead, neg = CS.integral_digit_matrix(x.data)
            side = torch.zeros_like(places)
            special = None
        elif T.is_floating(ft):
            v = x.data.to(torch.float64)
            digits, exps, side = K.dtoa_shortest(v)
            mat, lead = CS.shortest_digit_matrix(digits, exps)
            neg = torch.signbit(v)
            special = torch.where(torch.isnan(v), 1,
                                  torch.where(torch.isinf(v), 2, 0))
        else:
            raise NotImplementedError(
                f"format_number of {ft.simple_string()} (the JAX package "
                "formats a decimal's unscaled integer)")
        chars, lens = CS.format_number(mat, lead, side, neg, places, valid,
                                       special)
        return _str(chars, lens, valid)
