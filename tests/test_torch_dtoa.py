"""A double or float cast to a string in the port: the shortest digits of
``kernels.dtoa_shortest`` (the plain version of ``csrc/dtoa.cu`` here on
the CPU) in Java 19+'s ``Double.toString``/``Float.toString`` layout
(``ops/cast_strings.format_java_float``).

Held to the JAX package where its ``_java_double_str`` is Java's: zeros,
NaN, the infinities, 1e-3 <= |x| < 1e7 (Python's repr there is the
shortest, in plain notation) and where repr itself writes an exponent
(|x| >= 1e16 or < 1e-4).  Elsewhere held to a Python oracle of Java's rule
(``spark_rapids_tpu_torch.testing.java_text``: repr's or numpy's unique
digits, and for one digit the closest of one or two digits), because the
reference is wrong there (ROADMAP C): it prints 1e7 as ``10000000`` and
1.5e-4 as ``0.00014999999999999999`` (Java ``1.0E7``, ``1.5E-4``), and a
float through the double (``0.1f`` as ``0.10000000149011612``, Java
``0.1``); it also reads a subnormal double as 0.0 (``4.9E-324`` in
Java).  The tables of the kernel are checked against their exact
definitions."""

import math
import random
from fractions import Fraction

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql.expressions.cast import _java_double_str
from spark_rapids_tpu.sql.session import TpuSession
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch.ops import cast_strings as CS
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.testing.java_text import (dtoa_edges,
                                                      java_double, java_float)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TpuSession._active = None
    yield
    torch.set_num_threads(threads)
    TpuSession._active = None


def random_doubles(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    scaled = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 20, n)
    money = np.round(rng.random(n) * 104949 + 901, 2)
    return np.concatenate([bits.view(np.float64), scaled, money])


def texts(values: np.ndarray):
    x = torch.from_numpy(np.ascontiguousarray(values))
    chars, lens = CS.format_java_float(x, *K.dtoa_shortest(x)[:2])
    return [bytes(r[:n]).decode() for r, n in zip(chars.numpy(),
                                                  lens.numpy())]


@pytest.mark.parametrize("is_float", [False, True])
def test_tables_hold_their_definitions(is_float):
    """k is floor(log10 2^q) (or of 3/4 2^q), f2 floor(log2 10^-k), g the
    126-bit upper approximation of 10^-k 2^(125 - f2) (a float's its top
    63 bits plus one), c_tiny the subnormals whose candidates would have one
    digit."""
    t = K.dtoa_tables(is_float)
    q_min = t["q_min"]
    for i in range(0, t["nq"], 7):
        q = q_min + i
        v = Fraction(2) ** q
        k = t["kq"][0][i]
        assert Fraction(10) ** k <= v < Fraction(10) ** (k + 1)
        k3 = t["kq"][1][i]
        assert Fraction(10) ** k3 <= v * Fraction(3, 4) < \
            Fraction(10) ** (k3 + 1)
    for j in range(0, len(t["f2"]), 5):
        k = t["k_min"] + j
        f = t["f2"][j]
        p10 = Fraction(10) ** -k
        assert Fraction(2) ** f <= p10 < Fraction(2) ** (f + 1)
        exact = p10 * Fraction(2) ** (125 - f)
        if is_float:
            assert Fraction(t["g"][j]) * 2 ** 63 > exact
        else:
            g1, g0 = t["g"][j]
            g = g1 * 2 ** 63 + g0
            assert g - 1 <= exact < g
    k = t["kq"][0][0]
    unit = Fraction(2) ** q_min / Fraction(10) ** k
    assert math.floor(unit * t["c_tiny"]) >= 10 > math.floor(
        unit * (t["c_tiny"] - 1))


def test_double_digits_match_java():
    """Every double's text, over random bit patterns, scaled normals,
    money and the edges, equals the Java oracle's."""
    d_edge, _ = dtoa_edges()
    vals = np.concatenate([d_edge, random_doubles(1500, 7)])
    for v, got in zip(vals, texts(vals)):
        assert got == java_double(v), repr(v)


def test_float_digits_match_java():
    _, f_edge = dtoa_edges()
    rng = np.random.default_rng(8)
    bits = rng.integers(-(1 << 31), (1 << 31) - 1, 3000).astype(np.int32)
    vals = np.concatenate([f_edge, bits.view(np.float32),
                           np.float32(rng.standard_normal(500))])
    for v, got in zip(vals, texts(vals)):
        assert got == java_float(v), repr(v)


def test_java_layout_edges():
    cases = {1e7: "1.0E7", 1.5e-4: "1.5E-4", 1e23: "1.0E23",
             5e-324: "4.9E-324", 1e-3: "0.001", 9999999.0: "9999999.0",
             0.1: "0.1", -0.0: "-0.0", 100.0: "100.0", 1e16: "1.0E16",
             123456789.0: "1.23456789E8", 2.0 ** 63: "9.223372036854776E18",
             float("nan"): "NaN", float("-inf"): "-Infinity"}
    vals = np.array(list(cases), dtype=np.float64)
    assert texts(vals) == list(cases.values())
    assert texts(np.array([1.4e-45, 0.1, 3.4028235e38, 1e7],
                          dtype=np.float32)) == \
        ["1.4E-45", "0.1", "3.4028235E38", "1.0E7"]


def test_kernel_sides_against_the_exact_value():
    """The side of the digits against the double, which format_number
    rounds ties by: -1 below, 0 equal, 1 above."""
    import decimal
    vals = random_doubles(500, 9)
    vals = vals[np.isfinite(vals) & (vals != 0)]
    digits, exps, sides = K.dtoa_shortest(torch.from_numpy(vals))
    for v, d, e, s in zip(vals, digits.tolist(), exps.tolist(),
                          sides.tolist()):
        dec, ex = decimal.Decimal(d).scaleb(e), decimal.Decimal(abs(v))
        assert s == (dec > ex) - (dec < ex), repr(v)


def _strip(v: int):
    """(v without its trailing zeros, their count) in Python's integers."""
    count = 0
    while v and v % 10 == 0:
        v //= 10
        count += 1
    return v, count


@pytest.mark.parametrize("zeros", range(17))
def test_trailing_zero_strip(zeros):
    """The kernel's strip (``strip_zeros_plain``: 10^8 tested by a product
    with 5^-8 mod 2^64, then 10^8, 10^4, 10^2 and 10 mod 2^32 where the
    rest fits 32 bits, else mod 2^64, on 21-bit limbs) against Python's
    integers, for digits of up to 17 places ending in ``zeros`` zeros;
    through ``dtoa_plain``, doubles of 17 - ``zeros`` significant digits
    give those digits and exponent exactly (up to 15 digits, where
    the decimal is the double's shortest) or Java's text (16 and 17); and
    two-decimal money in [1e-3, 1e7) gives the JAX package's
    ``_java_double_str``, which is Java's there."""
    rng = random.Random(1700 + zeros)
    places = 17 - zeros
    leads = [rng.randrange(10 ** (n - 1), 10 ** n) for n in
             (rng.randint(1, places) for _ in range(300))]
    leads = [m + 1 if m % 10 == 0 else m for m in leads] + [
        1, 10 ** places - 1]
    ds = [m * 10 ** zeros for m in leads]
    d, e = K.strip_zeros_plain(torch.tensor(ds, dtype=torch.int64),
                               torch.full((len(ds),), -3, dtype=torch.int64))
    want = [_strip(v) for v in ds]
    assert d.tolist() == [w[0] for w in want]
    assert e.tolist() == [w[1] - 3 for w in want]
    assert all(w[1] == zeros for w in want)

    exps = [rng.randint(-20, 20) for _ in leads]
    full = [rng.randrange(10 ** (places - 1), 10 ** places) for _ in leads]
    full = [m + 1 if m % 10 == 0 else m for m in full]
    vals = np.array([float(f"{m}e{x}") for m, x in zip(full, exps)])
    digits, exponents, _ = K.dtoa_shortest(torch.from_numpy(vals))
    if places <= 15:
        assert digits.tolist() == full
        assert exponents.tolist() == exps
    for v, got in zip(vals, texts(vals)):
        assert got == java_double(v), repr(v)

    cents = np.array([rng.randrange(1, 10 ** 9) for _ in range(300)])
    money = cents / 100.0
    money = money[(money >= 1e-3) & (money < 1e7)]
    assert texts(money) == [_java_double_str(float(v)) for v in money]


def _reference_is_java(x: float) -> bool:
    """Where the JAX package's text is Java's; a subnormal it reads as 0.0
    (its CPU backend flushes subnormal doubles)."""
    ax = abs(x)
    if 0 < ax < np.finfo(np.float64).tiny:
        return False
    return not math.isfinite(x) or ax == 0 or 1e-3 <= ax < 1e7 or \
        ax >= 1e16 or ax < 1e-4


@pytest.fixture(scope="module")
def cast_table():
    vals = list(random_doubles(120, 11)) + [
        0.0, -0.0, 1.0, 0.001, 9999999.0, 1e16, 1e-5, 1e7, 1.5e-4, 1e23,
        5e-324, float("nan"), float("inf"), float("-inf"), 12345678.9]
    f32 = np.float32(np.random.default_rng(12).standard_normal(len(vals)))
    return pa.table({"u": pa.array(np.arange(len(vals))),
                     "d": pa.array(vals, pa.float64()),
                     "f": pa.array(f32, pa.float32())})


def test_cast_double_to_string_matches_reference_or_java(cast_table):
    """``CAST(d AS STRING)`` through both packages' SQL: equal to the JAX
    package where it writes Java's text; Java's text (the oracle)
    everywhere, the reference's 1e7 and 1.5e-4 named.  ``concat`` of a
    double (the port's implicit cast; the JAX package's concat fails on a
    double) gives the same text."""
    q = "SELECT u, CAST(d AS STRING) s FROM t ORDER BY u"
    port = srt.session(device="cpu")
    port.create_dataframe(cast_table).createOrReplaceTempView("t")
    ref = jsrt.session()
    ref.create_dataframe(cast_table).createOrReplaceTempView("t")
    got = port.sql(q.replace(" s FROM", " s, concat('<', d, '>') c FROM")
                   ).collect().to_pylist()
    want = ref.sql(q).collect().to_pylist()
    d = cast_table.column("d").to_pylist()
    same = 0
    for g, w, x in zip(got, want, d):
        assert g["s"] == java_double(x), repr(x)
        assert g["c"] == f"<{java_double(x)}>"
        if _reference_is_java(x):
            assert g["s"] == w["s"], repr(x)
            same += 1
    assert same > 100
    by_u = {r["u"]: r["s"] for r in want}
    assert by_u[d.index(1e7)] == "10000000"
    assert by_u[d.index(1.5e-4)] == "0.00014999999999999999"
    assert by_u[d.index(5e-324)] == "0.0"


def test_cast_float_to_string_is_float_toString(cast_table):
    """A float column's shortest digits are a float's (Java's
    Float.toString); the JAX package writes the double's."""
    port = srt.session(device="cpu")
    got = port.create_dataframe(cast_table).selectExpr(
        "u", "CAST(f AS STRING) s").collect().to_pylist()
    f = cast_table.column("f").to_numpy()
    for r in got:
        assert r["s"] == java_float(f[r["u"]])
    one = port.sql("SELECT CAST(CAST(0.1 AS FLOAT) AS STRING) s").collect()
    assert one.to_pylist() == [{"s": "0.1"}]
