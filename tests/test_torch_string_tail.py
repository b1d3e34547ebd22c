"""The string functions the JAX package runs per row on its host, on the
port's device path (here the plain versions on the CPU): ``md5`` (the hand
kernel ``csrc/md5.cu``'s plain version), ``conv`` (NumberConverter in torch
ops), ``format_number`` (from the shortest digits of ``csrc/dtoa.cu``), and
``translate`` and the trims with non-ASCII sets (code points on the
device).  Each runs through both packages' SQL over one numpy-seeded table
and is held to the JAX package's answer by the reference's rule.

Held to Spark where the JAX package is at fault (ROADMAP C):
``format_number`` of a double whose exact value has more than 17
significant digits shown (``1e23`` gives
``99,999,999,999,999,991,611,392.00`` in the JAX package,
``100,000,000,000,000,000,000,000.00`` in Spark, whose DecimalFormat
formats a double from its shortest digits and rounds a tie in them by the
exact value), of NaN and the infinities (Java's ``NaN`` and ``∞``, Python's
``nan`` and ``inf``), and of a long past 2^53 (Python goes through the
double).  The oracle is ``testing.java_text.java_format_number``, built on
Python's ``decimal``."""

import hashlib
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
from spark_rapids_tpu.sql.session import TpuSession
from spark_rapids_tpu.testing.asserts import _norm
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.testing.java_text import java_format_number


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TpuSession._active = None
    yield
    torch.set_num_threads(threads)
    TpuSession._active = None


def random_text(rng, n, alphabet, max_len=20):
    a = np.array(list(alphabet))
    return ["".join(rng.choice(a, k)) for k in rng.integers(0, max_len, n)]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(16)
    n = 200
    s = random_text(rng, n, "0123456789abcdefXYZ -+\t") + [
        "-1", "18446744073709551615", "18446744073709551616",
        "-9223372036854775808", "zz", " 12", "", "-", "ff", None]
    words = random_text(rng, len(s), "aeéüxyz中 ", 12)
    words[3] = None
    d = np.concatenate([rng.standard_normal(len(s) - 12)
                        * 10.0 ** rng.integers(-4, 14, len(s) - 12),
                        [0.125, 2.675, 1.005, -0.0, 0.5, 1.5, 999.995,
                         1234567.891, -42.0, 0.045, 123456789.125, 7.0]])
    i = rng.integers(-(1 << 40), 1 << 40, len(s))
    i[:4] = [0, -1, 1 << 52, -(1 << 52)]
    return pa.table({"u": pa.array(np.arange(len(s))),
                     "s": pa.array(s, pa.string()),
                     "w": pa.array(words, pa.string()),
                     "d": pa.array(d), "i": pa.array(i),
                     "f": pa.array(np.float32(d / 7.0))})


@pytest.fixture(scope="module")
def sessions(table):
    ref = jsrt.session()
    ref.create_dataframe(table, num_partitions=2).createOrReplaceTempView(
        "t")
    port = srt.session(device="cpu")
    port.create_dataframe(table, num_partitions=2).createOrReplaceTempView(
        "t")
    return ref, port


def both(sessions, sql):
    ref, port = sessions
    got = _norm(port.sql(sql).collect().to_pylist())
    want = _norm(ref.sql(sql).collect().to_pylist())
    key = (lambda r: r["u"])
    return sorted(got, key=key), sorted(want, key=key)


def test_md5_plain_matches_hashlib_at_the_padding_edges():
    rng = np.random.default_rng(5)
    for width in (8, 64, 128, 130):
        lens = np.array([0, 55, 56, 63, 64, 119, 120, 1, width],
                        dtype=np.int32).clip(0, width)
        chars = rng.integers(0, 256, (lens.size, width), dtype=np.uint8)
        got = K.md5(torch.from_numpy(chars), torch.from_numpy(lens)).numpy()
        for r in range(lens.size):
            want = hashlib.md5(bytes(chars[r, :lens[r]])).hexdigest()
            assert bytes(got[r]).decode() == want, (width, lens[r])
    assert K.LAUNCHES["md5"] == 0


@pytest.mark.parametrize("width", [8, 64, 130])
def test_md5_plain_with_valid(width):
    """``valid`` marks the rows to hash: a valid row is hashlib's digest, a
    row that is not valid 32 zero bytes (its bytes and length aside), and
    with ``valid`` omitted every row is hashed as before."""
    rng = np.random.default_rng(width)
    n = 300
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    lens[:4] = [0, width, min(55, width), min(56, width)]
    chars = rng.integers(0, 256, (n, width), dtype=np.uint8)
    valid = rng.random(n) < 0.7
    valid[:2] = [True, False]
    valid[-37:] = False                     # a dead tail
    c, ln = torch.from_numpy(chars), torch.from_numpy(lens)
    got = K.md5_plain(c, ln, torch.from_numpy(valid)).numpy()
    every = K.md5_plain(c, ln).numpy()
    for r in range(n):
        want = hashlib.md5(bytes(chars[r, :lens[r]])).hexdigest()
        assert bytes(every[r]).decode() == want, (width, lens[r])
        if valid[r]:
            assert bytes(got[r]).decode() == want, (width, lens[r])
        else:
            assert not got[r].any(), r
    np.testing.assert_array_equal(
        K.md5(c, ln, torch.from_numpy(valid)).numpy(), got)
    assert K.LAUNCHES["md5"] == 0


def test_md5_matches_reference(sessions):
    got, want = both(sessions, "SELECT u, md5(s) a, md5(w) b FROM t")
    assert got == want


@pytest.mark.parametrize("bases", [(10, 16), (16, 10), (10, -16), (2, 36),
                                   (36, 2), (16, -10), (1, 10), (10, 37)])
def test_conv_matches_reference(sessions, bases):
    fb, tb = bases
    got, want = both(sessions, f"SELECT u, conv(s, {fb}, {tb}) c FROM t")
    assert got == want


def test_translate_and_trim_with_non_ascii_sets_match_reference(sessions):
    got, want = both(sessions, """SELECT u, translate(w, 'é中', 'e') a,
        translate(w, 'aé', 'äè') b, translate(w, 'üx', '') c,
        trim(w, 'é ') e, ltrim(w, '中') f, rtrim(w, 'é中z') g,
        translate(s, 'ab', 'é中') h FROM t""")
    assert got == want


def _python_is_java(x: float, d: int) -> bool:
    """Where Python's exact-value formatting shows no digit past the
    shortest digits' 17 (the JAX package's f-string agrees)."""
    return math.isfinite(x) and (abs(x) < 1e15 and d <= 2)


@pytest.mark.parametrize("places", [0, 2, 3])
def test_format_number_matches_reference_or_spark(sessions, table, places):
    got, want = both(sessions, f"""SELECT u, format_number(d, {places}) a,
        format_number(i, {places}) b FROM t""")
    d = table.column("d").to_pylist()
    i = table.column("i").to_pylist()
    for g, w in zip(got, want):
        x = d[g["u"]]
        assert g["a"] == java_format_number(x, places), repr(x)
        if _python_is_java(x, places):
            assert g["a"] == w["a"], repr(x)
        assert g["b"] == f"{i[g['u']]:,.{places}f}"
        if abs(i[g["u"]]) < 1 << 53:
            assert g["b"] == w["b"]


def test_format_number_of_floats_widens_to_the_double(sessions, table):
    got, want = both(sessions, "SELECT u, format_number(f, 4) a FROM t")
    f = table.column("f").to_numpy()
    for g, w in zip(got, want):
        x = float(f[g["u"]])
        assert g["a"] == java_format_number(x, 4) == w["a"], x


def test_format_number_where_the_reference_differs():
    """1e23, NaN and the infinities, a long past 2^53 and d < 0 (null)."""
    port = srt.session(device="cpu")
    df = port.create_dataframe({
        "x": np.array([1e23, float("nan"), float("inf"), -float("inf"),
                       0.1]),
        "l": np.array([2 ** 63 - 1, -2 ** 63, 2 ** 53 + 1, 0, 5])})
    got = df.selectExpr("format_number(x, 2) a", "format_number(l, 0) b",
                        "format_number(x, -1) c").collect().to_pylist()
    assert [r["a"] for r in got] == [
        "100,000,000,000,000,000,000,000.00", "NaN", "∞", "-∞",
        "0.10"]
    assert [r["b"] for r in got] == [
        "9,223,372,036,854,775,807", "-9,223,372,036,854,775,808",
        "9,007,199,254,740,993", "0", "5"]
    assert all(r["c"] is None for r in got)
    ref = jsrt.session()
    t = pa.table({"x": [1e23]})
    assert ref.create_dataframe(t).selectExpr(
        "format_number(x, 2) a").collect().to_pylist() == [
            {"a": "99,999,999,999,999,991,611,392.00"}]


def test_format_number_of_a_decimal_raises():
    """The JAX package formats a decimal column's unscaled integer
    (``format_number(CAST(1.5 AS DECIMAL(10,2)), 1)`` gives 150.0); the
    port raises until it formats decimals as Spark does."""
    port = srt.session(device="cpu")
    df = port.create_dataframe({"x": np.array([1.5])})
    with pytest.raises(NotImplementedError, match="decimal"):
        df.selectExpr("format_number(CAST(x AS DECIMAL(10, 2)), 1)"
                      ).collect()
    ref = jsrt.session()
    got = ref.create_dataframe(pa.table({"x": [1.5]})).selectExpr(
        "format_number(CAST(x AS DECIMAL(10, 2)), 1) a").collect()
    assert got.to_pylist() == [{"a": "150.0"}]
