"""The port's window family (spark_rapids_tpu_torch) held against the JAX
package: the window ops on the same arrays, and windowed queries through
both packages' DataFrame API on the same tables, split into the same
partitions, under the same configuration.

Tolerances, by the reference's rule (``testing/asserts.py:27-37``): integer
results, indices, flags and nulls are exact; a double computed from a frame
sum (sum, avg over doubles) agrees to rtol=1e-9, because the port and the
JAX package take the difference of two entries of a cumsum added in another
order (a sequential XLA scan on the CPU, a parallel scan on CUDA); against a
numpy oracle that sums inside each key, such a sum also gets an absolute
1e-9 of the largest prefix it subtracts, the scale of its rounding; every
other double (copied by lead/lag, min/max, the rank ratios) is exact."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu.config import RapidsConf
from spark_rapids_tpu.ops import window_ops as JW
from spark_rapids_tpu.sql import Window as JWindow
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql import plan as JP
from spark_rapids_tpu.sql.session import TpuSession
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import window_ops as W
from spark_rapids_tpu_torch.sql import Window
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql import plan as P
from spark_rapids_tpu_torch.sql.physical.exchange import ShuffleExchangeExec
from spark_rapids_tpu_torch.sql.physical.window import (WindowExec,
                                                        WindowGroupLimitExec)

from test_torch_partitioned import lineitem

MIN_ROWS = "spark.sql.adaptive.coalescePartitions.minRows"
TARGET = "spark.rapids.sql.window.batchTargetRows"
RTOL_SUM = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _fresh_reference_session():
    """The JAX session is a process-wide singleton that keeps the last conf
    it was made with: leave a default one behind for other modules."""
    yield
    TpuSession._active = None


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# ops: boundary_flags, segment_bounds, range_reduce, frame aggregations
# --------------------------------------------------------------------------

def _segment_keys(case):
    """(key arrays, validity arrays) of a sorted batch."""
    rng = np.random.default_rng(5)
    if case == "empty":
        return [np.zeros(0, np.int64)], [np.zeros(0, bool)]
    if case == "one_row":
        return [np.array([7], np.int64)], [np.array([True])]
    if case == "one_segment":
        return [np.full(50, 3, np.int64)], [np.ones(50, bool)]
    if case == "singletons":
        return [np.arange(64, dtype=np.int64)], [np.ones(64, bool)]
    if case == "dead_tail":
        # 37 live rows in 8 keys, then dead rows (zero data, invalid) up to
        # capacity 64
        k = np.zeros(64, np.int64)
        k[:37] = np.sort(rng.integers(0, 8, 37))
        v = np.arange(64) < 37
        return [k], [v]
    # two keys, nulls in the second, ties everywhere
    k1 = np.sort(rng.integers(0, 5, 300))
    k2 = rng.integers(0, 3, 300)
    order = np.lexsort((k2, k1))
    v2 = rng.random(300) > 0.2
    return [k1[order], np.where(v2, k2[order], 0)], [np.ones(300, bool), v2]


@pytest.mark.parametrize("case", ["empty", "one_row", "one_segment",
                                  "singletons", "dead_tail", "two_keys"])
def test_boundary_flags_and_segment_bounds_equal_reference(case):
    keys, valids = _segment_keys(case)
    ref_flags = JW.boundary_flags(np, keys, valids)
    flags = W.boundary_flags([_t(k) for k in keys]
                             + [_t(v).to(torch.int64) for v in valids])
    np.testing.assert_array_equal(flags.numpy(), ref_flags)
    ref_start, ref_end = JW.segment_bounds(np, ref_flags)
    start, end = W.segment_bounds(flags)
    assert start.dtype == end.dtype == torch.int64
    np.testing.assert_array_equal(start.numpy(), ref_start)
    np.testing.assert_array_equal(end.numpy(), ref_end)


@pytest.mark.parametrize("p_start", [0.0, 0.3, 1.0])
def test_segment_bounds_without_a_start_at_row_zero_equal_reference(p_start):
    flags = np.random.default_rng(2).random(40) < p_start
    flags[0] = False
    ref = JW.segment_bounds(np, flags)
    got = W.segment_bounds(_t(flags))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)


def _random_bounds(rng, n):
    starts = rng.integers(-2, n + 1, n)
    ends = np.minimum(starts + rng.integers(-3, 40, n), n)   # some empty
    return starts.astype(np.int32), ends.astype(np.int32)


@pytest.mark.parametrize("dtype", [np.float64, np.int32, np.int64])
@pytest.mark.parametrize("op", ["min", "max"])
def test_range_reduce_and_frame_min_max_equal_reference(dtype, op):
    rng = np.random.default_rng(9)
    n = 1000
    v = (rng.standard_normal(n) * 100).astype(dtype)
    valid = rng.random(n) > 0.15
    s, e = _random_bounds(rng, n)
    if np.issubdtype(dtype, np.floating):
        ident = np.inf if op == "min" else -np.inf
    else:
        info = np.iinfo(dtype)
        ident = int(info.max if op == "min" else info.min)
    ref = JW.range_reduce(np, v, s, e, op, ident)
    got = W.range_reduce(_t(v), _t(s).long(), _t(e).long(), op, ident)
    np.testing.assert_array_equal(got.numpy(), ref)
    jfn, fn = ((JW.frame_min, W.frame_min) if op == "min"
               else (JW.frame_max, W.frame_max))
    ref_v, ref_has = jfn(np, v, valid, s, e, ident)
    got_v, got_has = fn(_t(v), _t(valid), _t(s).long(), _t(e).long(), ident)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    np.testing.assert_array_equal(got_has.numpy(), ref_has)


@pytest.mark.parametrize("dtype", [np.float64, np.int64])
def test_frame_sum_and_count_match_reference(dtype):
    rng = np.random.default_rng(4)
    n = 2000
    v = (rng.standard_normal(n) * 1000).astype(dtype)
    valid = rng.random(n) > 0.1
    s, e = _random_bounds(rng, n)
    ts, te = _t(s).long(), _t(e).long()
    ref = JW.frame_sum(np, v, valid, s, e)
    got = W.frame_sum(_t(v), _t(valid), ts, te)
    if dtype == np.float64:
        # a difference of two cumsum entries: rtol against the scale of the
        # prefix, not of the (possibly tiny) difference
        scale = np.abs(np.where(valid, v, 0)).sum()
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=RTOL_SUM * scale)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(W.frame_count(_t(valid), ts, te).numpy(),
                                  JW.frame_count(np, valid, s, e))


def test_first_and_last_valid_index_equal_reference():
    rng = np.random.default_rng(6)
    n = 500
    valid = rng.random(n) > 0.6
    s, e = _random_bounds(rng, n)
    for jfn, fn in ((JW.frame_first_valid_index, W.frame_first_valid_index),
                    (JW.frame_last_valid_index, W.frame_last_valid_index)):
        ref = jfn(np, valid, s, e)
        got = fn(_t(valid), _t(s).long(), _t(e).long())
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r)


# --------------------------------------------------------------------------
# queries through both packages
# --------------------------------------------------------------------------

def make_table(n=600, seed=3, nulls=True):
    """g: 7 keys with nulls; o: 40 values with ties and nulls; v: integer
    doubles with nulls; x: random doubles; i: int32 with nulls; u: unique
    (a total order to sort results by)."""
    rng = np.random.default_rng(seed)

    def nullable(a, p):
        return pa.array(a, mask=(rng.random(n) < p) if nulls else None)
    return pa.table({
        "g": nullable(rng.integers(0, 7, n), 0.05),
        "o": nullable(rng.integers(0, 40, n), 0.05),
        "v": nullable(rng.integers(-50, 50, n).astype(np.float64), 0.1),
        "x": pa.array(rng.random(n)),
        "i": nullable(rng.integers(-1000, 1000, n).astype(np.int32), 0.1),
        "u": pa.array(np.arange(n, dtype=np.int64)),
    })


def _run_both(table, query, conf=None, num_partitions=1):
    """(port result, reference result, port session): ``query(df, F,
    Window)`` through both packages."""
    conf = dict(conf or {})
    jsess = jsrt.session(conf=RapidsConf.get_global().copy(conf))
    ref = query(jsess.create_dataframe(table, num_partitions=num_partitions),
                JF, JWindow).collect()
    sess = srt.session(device="cpu", conf=conf)
    got = query(sess.create_dataframe(table, num_partitions=num_partitions),
                F, Window).collect()
    return got, ref, sess


def _assert_match(got, ref, sort_by=("u",), summed=()):
    """Same columns, rows matched by the ``sort_by`` columns (none: in
    the order they came); nulls and every value exact, but the ``summed``
    double columns at rtol 1e-9."""
    assert got.column_names == ref.column_names
    assert got.num_rows == ref.num_rows
    g_order = r_order = np.arange(got.num_rows)
    if sort_by:
        g_order = np.lexsort([np.ma.getdata(got.column(c))
                              for c in reversed(sort_by)])
        r_order = np.lexsort([ref.column(c).to_numpy(zero_copy_only=False)
                              for c in reversed(sort_by)])
    for name, ref_col in zip(ref.column_names, ref.columns):
        g = got.column(name)[g_order]
        r_null = np.asarray(ref_col.is_null())[r_order]
        np.testing.assert_array_equal(np.ma.getmaskarray(g), r_null, name)
        ok = ~r_null
        r = ref_col.to_numpy(zero_copy_only=False)[r_order][ok]
        if name in summed:
            np.testing.assert_allclose(np.ma.getdata(g)[ok], r.astype(float),
                                       rtol=RTOL_SUM, err_msg=name)
        else:
            np.testing.assert_array_equal(np.ma.getdata(g)[ok], r, name)


@pytest.mark.parametrize("num_partitions", [1, 3])
def test_rank_family_and_ntile_under_ties_match_reference(num_partitions):
    def query(df, F, Window):
        w = Window.partitionBy("g").orderBy("o")
        wd = Window.partitionBy("g").orderBy(F.col("o").desc(), "u")
        return df.select(
            "u", "g", "o",
            F.row_number().over(wd).alias("rn"),
            F.rank().over(w).alias("rk"),
            F.dense_rank().over(w).alias("dr"),
            F.percent_rank().over(w).alias("pr"),
            F.cume_dist().over(w).alias("cd"),
            F.ntile(4).over(w).alias("nt4"),
            F.ntile(100).over(wd).alias("nt100"))
    got, ref, _ = _run_both(make_table(), query, {MIN_ROWS: 0},
                            num_partitions)
    _assert_match(got, ref)
    assert got.types[3:] == [srt.types.INT] * 3 + [srt.types.DOUBLE] * 2 \
        + [srt.types.INT] * 2


def test_lead_and_lag_with_and_without_default_match_reference():
    def query(df, F, Window):
        w = Window.partitionBy("g").orderBy("o", "u")
        return df.select(
            "u", F.lag("v").over(w).alias("lag1"),
            F.lead(F.col("v"), 2).over(w).alias("lead2"),
            F.lag("v", 1, -999.0).over(w).alias("lag_d"),
            F.lead("i", 3, 7).over(w).alias("lead_i"),
            F.lag("o", 5).over(w).alias("lag_o"))
    got, ref, _ = _run_both(make_table(), query)
    _assert_match(got, ref)


@pytest.mark.parametrize("num_partitions,frame_names", [
    (1, "dstwr"), (3, "dw")], ids=["one_partition", "3_partitions"])
def test_first_last_and_nth_value_match_reference(num_partitions,
                                                  frame_names):
    """Windowed first/last (with and without ignore nulls) and nth_value
    over the default, sliding, whole-partition and RANGE frames, ordered
    by (o, u), a total order (over 3 partitions, two frames: the
    reference compiles each frame's programs per partition)."""
    def query(df, F, Window):
        w = Window.partitionBy("g").orderBy("o", "u")
        frames = (("d", w), ("s", w.rowsBetween(-2, 2)),
                  ("t", w.rowsBetween(1, Window.unboundedFollowing)),
                  ("w", Window.partitionBy("g")),
                  ("r", Window.partitionBy("g").orderBy("o")
                   .rangeBetween(-3, 0)))
        cols = ["u"]
        for name, f in frames:
            if name not in frame_names:
                continue
            cols += [F.first("v").over(f).alias(f"{name}first"),
                     F.last("i").over(f).alias(f"{name}last"),
                     F.first("v", True).over(f).alias(f"{name}firstnn"),
                     F.last("v", ignorenulls=True).over(f)
                     .alias(f"{name}lastnn"),
                     F.nth_value("v", 2).over(f).alias(f"{name}nth2"),
                     F.nth_value("i", 3, True).over(f).alias(f"{name}nth3nn")]
        return df.select(*cols)
    got, ref, _ = _run_both(make_table(), query, {MIN_ROWS: 0},
                            num_partitions)
    _assert_match(got, ref)


def test_nth_value_and_first_last_over_strings_match_python():
    """nth_value/first/last of a string column, against a Python walk of
    each window partition."""
    rng = np.random.default_rng(12)
    n = 300
    g = rng.integers(0, 9, n)
    s = np.array(["", "a", "é中", "bb", "zzzzzzzzzz"], dtype=object)[
        rng.integers(0, 5, n)]
    s[rng.random(n) < 0.2] = None
    t = pa.table({"g": pa.array(g), "s": pa.array(s.tolist(), pa.string()),
                  "u": pa.array(np.arange(n, dtype=np.int64))})
    w = Window.partitionBy("g").orderBy("u")
    got = srt.session(device="cpu").create_dataframe(t, 2).select(
        "u", F.nth_value("s", 2).over(w).alias("nth"),
        F.nth_value("s", 2, True).over(w.rowsBetween(
            Window.unboundedPreceding, Window.unboundedFollowing))
        .alias("nthnn"),
        F.first("s").over(w).alias("first"),
        F.last("s", True).over(w).alias("lastnn")).collect()
    rows = {r["u"]: r for r in got.to_pylist()}
    for u in range(n):
        part = [i for i in range(n) if g[i] == g[u]]
        upto = [i for i in part if i <= u]
        vals = [s[i] for i in part if s[i] is not None]
        seen = [s[i] for i in upto if s[i] is not None]
        assert rows[u]["nth"] == (s[upto[1]] if len(upto) > 1 else None)
        assert rows[u]["nthnn"] == (vals[1] if len(vals) > 1 else None)
        assert rows[u]["first"] == s[upto[0]]
        assert rows[u]["lastnn"] == (seen[-1] if seen else None)


def test_running_and_sliding_rows_frames_match_reference():
    def query(df, F, Window):
        running = Window.partitionBy("g").orderBy("u")
        sliding = running.rowsBetween(-2, 2)
        head = running.rowsBetween(Window.unboundedPreceding, 1)
        tail = running.rowsBetween(-3, Window.unboundedFollowing)
        whole = Window.partitionBy("g")
        cols = ["u"]
        for name, w in (("r", running), ("s", sliding), ("h", head),
                        ("t", tail), ("w", whole)):
            cols += [F.sum("v").over(w).alias(f"{name}sum"),
                     F.sum("x").over(w).alias(f"{name}sumx"),
                     F.sum("i").over(w).alias(f"{name}sumi"),
                     F.count("v").over(w).alias(f"{name}cnt"),
                     F.count("*").over(w).alias(f"{name}all"),
                     F.avg("x").over(w).alias(f"{name}avg"),
                     F.min("v").over(w).alias(f"{name}min"),
                     F.max("i").over(w).alias(f"{name}max")]
        return df.select(*cols)
    got, ref, _ = _run_both(make_table(), query, {MIN_ROWS: 0}, 2)
    _assert_match(got, ref, summed={c for c in got.column_names
                                    if c.endswith(("sumx", "avg"))})


def test_range_frames_over_peers_match_reference():
    def query(df, F, Window):
        w = Window.partitionBy("g").orderBy("o")           # default frame
        to_end = w.rangeBetween(Window.currentRow, Window.unboundedFollowing)
        peers = w.rangeBetween(0, 0)
        return df.select(
            "u", F.sum("x").over(w).alias("s"),
            F.count("v").over(w).alias("c"),
            F.min("i").over(to_end).alias("mn"),
            F.max("v").over(peers).alias("mx"),
            F.avg("v").over(to_end).alias("a"))
    got, ref, _ = _run_both(make_table(), query)
    _assert_match(got, ref, summed={"s", "a"})


@pytest.mark.parametrize("frame,order", [
    ((-5, 5), "asc"), ((-3, 0), "desc"), ((-2, 4), "desc"),
    ((Window.unboundedPreceding, 2), "asc"),
    ((-3, Window.unboundedFollowing), "desc"),
    ((1, 6), "double")])
def test_range_frames_with_numeric_offsets_match_reference(frame, order):
    lo, up = frame

    def query(df, F, Window):
        # ascending puts null order keys first, descending last
        key = {"asc": F.col("o"), "desc": F.col("o").desc(),
               "double": F.col("v")}[order]
        w = Window.partitionBy("g").orderBy(key).rangeBetween(lo, up)
        return df.select("u", F.sum("x").over(w).alias("s"),
                         F.count("v").over(w).alias("c"),
                         F.count("*").over(w).alias("n"),
                         F.min("i").over(w).alias("mn"))
    got, ref, _ = _run_both(make_table(), query)
    _assert_match(got, ref, summed={"s"})


def test_range_frame_keeps_int64_precision():
    base = 10_000_000_000_000_000    # beyond float64's integers
    table = pa.table({"g": [1] * 4 + [2] * 2,
                      "o": [base, base + 1, base + 2, base + 3, base, base],
                      "v": [1.0] * 6, "u": list(range(6))})

    def query(df, F, Window):
        w = Window.partitionBy("g").orderBy("o").rangeBetween(-1, 0)
        return df.select("u", "o", F.count("v").over(w).alias("c"))
    got, ref, _ = _run_both(table, query)
    _assert_match(got, ref)
    assert got.column("c")[np.argsort(got.column("u"))].tolist() == \
        [1, 2, 2, 2, 2, 2]


def _spark_range_counts(g, v, valid, lo, up, ascending):
    """count(*) over partitionBy(g).orderBy(v).rangeBetween(lo, up) by
    Spark's RangeFrame rule, in plain Python.  A row's frame holds the rows
    of its window partition that sort between its two bounds, v + lo and
    v + up (v - lo and v - up for a descending key), or the partition's
    ends for unbounded sides.  The sort puts NaN above every number and
    equal to NaN, so NaN and +-inf plus a finite offset stay themselves;
    nulls sort first ascending and last descending, and a null key's bound
    is null, which its null peers equal.  An integral bound saturates at
    the int64 range."""
    ints = np.issubdtype(np.asarray(v).dtype, np.integer)
    sign = 1 if ascending else -1

    def pos(x):                         # a key's place in the sort
        if x is None:
            return (0, 0, 0) if ascending else (2, 0, 0)
        nan = not ints and bool(np.isnan(x))
        if ascending:
            return (1, int(nan), 0 if nan else x)
        return (1, int(not nan), 0 if nan else -x)

    def bound(x, k):
        if x is None:
            return None
        if ints:
            return min(max(int(x) + sign * k, -(1 << 63)), (1 << 63) - 1)
        return float(x) + sign * k
    v = np.asarray(v)
    keys = [v[i].item() if valid[i] else None for i in range(len(g))]
    out = []
    for i in range(len(g)):
        a = None if lo == Window.unboundedPreceding else pos(bound(keys[i],
                                                                   lo))
        b = None if up == Window.unboundedFollowing else pos(bound(keys[i],
                                                                   up))
        out.append(sum(g[j] == g[i] and (a is None or a <= pos(keys[j]))
                       and (b is None or pos(keys[j]) <= b)
                       for j in range(len(g))))
    return out


def _range_counts(g, v, lo, up, ascending=True, valid=None, parts=1):
    valid = np.ones(len(g), bool) if valid is None else valid
    data = {"g": np.asarray(g, dtype=np.int64),
            "v": np.ma.MaskedArray(np.asarray(v), mask=~valid),
            "u": np.arange(len(g), dtype=np.int64)}
    sess = srt.session(device="cpu", conf={MIN_ROWS: 0})
    df = sess.create_dataframe(data, num_partitions=parts)
    key = F.col("v") if ascending else F.col("v").desc()
    w = Window.partitionBy("g").orderBy(key).rangeBetween(lo, up)
    got = df.select("u", F.count("*").over(w).alias("c")).collect()
    return np.asarray(got.column("c"))[np.argsort(got.column("u"))].tolist()


@pytest.mark.parametrize("g,v,want", [
    ([1, 1, 1], [1.0, np.nan, 3.0], [1, 1, 1]),
    ([1, 1, 1, 2, 2], [1.0, np.inf, 3.0, -1.0, 2.0], [1, 1, 1, 1, 1]),
    ([1, 1, 1], np.array([-(1 << 62), 0, 1 << 62]), [1, 1, 1])],
    ids=["nan", "inf", "int62"])
@pytest.mark.parametrize("ascending", [True, False], ids=["asc", "desc"])
def test_range_frame_with_nan_inf_and_extreme_keys_gives_sparks_frames(
        g, v, want, ascending):
    """ROADMAP C1.  The reference gives other frames here (its composite
    key v + seg_id * span needs a finite span, ``window.py:251-265``), so
    the port is held to Spark's answer."""
    assert _range_counts(g, v, -1, 1, ascending) == want
    assert _spark_range_counts(g, v, np.ones(len(g), bool), -1, 1,
                               ascending) == want


@pytest.mark.parametrize("kind", ["float", "float32", "int64_edges"])
@pytest.mark.parametrize("frame", [(-1, 1), (-3, 0), (2, 5),
                                   (Window.unboundedPreceding, 2)])
@pytest.mark.parametrize("ascending", [True, False], ids=["asc", "desc"])
def test_range_frames_over_special_keys_match_a_spark_oracle(kind, frame,
                                                             ascending):
    """Random keys with NaN, +-inf, -0.0 and nulls, or int64 values at both
    ends of the range (saturating bounds), over 3 partitions: every row's
    count equals the plain-Python oracle of Spark's rule, unbounded sides
    of null rows included."""
    rng = np.random.default_rng(21)
    n = 240
    g = rng.integers(0, 9, n)
    if kind == "int64_edges":
        edges = np.array([-(1 << 63), -(1 << 63) + 1, -(1 << 63) + 3,
                          -(1 << 62), -1, 0, 1, 1 << 62, (1 << 63) - 4,
                          (1 << 63) - 2, (1 << 63) - 1])
        v = edges[rng.integers(0, edges.size, n)]
    else:
        v = rng.integers(-6, 6, n).astype(np.float64) / 2
        special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0])
        pick = rng.random(n) < 0.25
        v[pick] = special[rng.integers(0, special.size, pick.sum())]
        if kind == "float32":
            v = v.astype(np.float32)
    valid = rng.random(n) > 0.08
    lo, up = frame
    got = _range_counts(g, v, lo, up, ascending, valid, parts=3)
    assert got == _spark_range_counts(g, v, valid, lo, up, ascending)


def test_rows_between_rejects_offsets_outside_the_int_range():
    """ROADMAP C2: Spark's ``WindowSpec.rowsBetween`` takes a row offset in
    the int range or an unbounded sentinel, and raises otherwise."""
    w = Window.partitionBy("g").orderBy("u")
    for start, end in ((-3_000_000_000, 0), (0, 1 << 31), (-(1 << 31) - 1, 0),
                       (Window.unboundedFollowing, 0),
                       (0, Window.unboundedPreceding)):
        with pytest.raises(ValueError):
            w.rowsBetween(start, end)
        with pytest.raises(ValueError):
            Window.rowsBetween(start, end)
    for start, end in ((-(1 << 31), (1 << 31) - 1),
                       (Window.unboundedPreceding, Window.unboundedFollowing),
                       (-3, 3)):
        assert w.rowsBetween(start, end).to_definition().frame.lower == start


def test_window_without_partition_keys_and_two_chained_specs():
    def query(df, F, Window):
        w_all = Window.orderBy("u")
        w_g = Window.partitionBy("g").orderBy("u")
        return df.select("u", F.row_number().over(w_all).alias("rn"),
                         F.sum("x").over(w_all).alias("s"),
                         F.row_number().over(w_g).alias("rn_g"),
                         F.lag("v").over(w_g).alias("prev"))
    got, ref, sess = _run_both(make_table(300), query, {MIN_ROWS: 0}, 3)
    _assert_match(got, ref, summed={"s"})
    assert got.column("rn")[np.argsort(got.column("u"))].tolist() == \
        list(range(1, 301))
    windows = _find(sess.last_plan, WindowExec)
    assert len(windows) == 2
    # the spec without keys (planned first) gathers every row into one
    # partition, so the keyed spec above it needs no exchange
    assert [e.partitioning.simple_string()
            for e in _find(sess.last_plan, ShuffleExchangeExec)] == \
        ["SinglePartitioning(1)"]


def _find(phys, cls):
    found = [phys] if isinstance(phys, cls) else []
    for c in phys.children:
        found.extend(_find(c, cls))
    return found


def _logical_windows(plan, window_cls):
    n = int(isinstance(plan, window_cls))
    return n + sum(_logical_windows(c, window_cls) for c in plan.children)


def test_identical_specs_share_one_window_node():
    table = make_table(30)
    for pkg, F_, Window_, win_cls in (
            (srt.session(device="cpu"), F, Window, P.Window),
            (jsrt.session(), JF, JWindow, JP.Window)):
        df = pkg.create_dataframe(table)
        w1 = Window_.partitionBy("g").orderBy("o")
        w2 = Window_.partitionBy("g").orderBy("o")
        out = df.select("u", F_.row_number().over(w1).alias("a"),
                        F_.rank().over(w2).alias("b"),
                        F_.rank().over(w2).alias("c"))
        assert _logical_windows(out._plan, win_cls) == 1


def test_unported_window_functions_raise():
    with pytest.raises(ValueError):
        F.ntile(0)
    with pytest.raises(ValueError):
        F.nth_value("v", 0)
    df = srt.session(device="cpu").create_dataframe(
        {"s": np.array(["a", "b"]), "v": np.array([1.0, 2.0])})
    with pytest.raises(NotImplementedError):
        df.select(F.first("v").over(
            Window.orderBy("s").rangeBetween(-1, 1))).collect()


# --------------------------------------------------------------------------
# key-batched execution
# --------------------------------------------------------------------------

def _keyed_table(n=2000, keys=60, seed=13):
    rng = np.random.default_rng(seed)
    return pa.table({"g": np.sort(rng.integers(0, keys, n)),
                     "x": rng.random(n), "u": np.arange(n, dtype=np.int64)})


def _keyed_query(df, F, Window):
    """Three window expressions of one (partition, order) spec: one
    Window node."""
    w = Window.partitionBy("g").orderBy("x")
    return df.select("g", "x", "u", F.row_number().over(w).alias("r"),
                     F.sum(F.col("x")).over(w).alias("s"),
                     F.max("u").over(w.rowsBetween(-1, 1)).alias("m"))


def _key_batches(sess):
    (window,) = _find(sess.last_plan, WindowExec)
    return window.key_batches


def test_key_batched_chunks_match_one_chunk_and_reference():
    table = _keyed_table()
    got, ref, one = _run_both(table, _keyed_query)
    _assert_match(got, ref, summed={"s"})
    assert _key_batches(one) == 1
    small = srt.session(device="cpu", conf={TARGET: 4})
    chunked = _keyed_query(small.create_dataframe(table), F,
                           Window).collect()
    assert _key_batches(small) > 40
    _assert_match(chunked, got.to_arrow(), summed={"s"})


def test_key_batched_grows_a_chunk_to_a_giant_partition():
    n = 300
    table = pa.table({"g": [5] * 200 + [6] * 30 + [7] * 70,
                      "x": np.random.default_rng(1).random(n),
                      "u": np.arange(n, dtype=np.int64)})
    got, ref, sess = _run_both(table, _keyed_query, {TARGET: 40})
    _assert_match(got, ref, summed={"s"})
    # the giant partition alone (grown past the target), then the 30 rows,
    # then the last 70 (a carry below nothing to cut, computed at the end)
    assert _key_batches(sess) == 3
    r = got.column("r")[np.argsort(got.column("u"))]
    assert r[:200].tolist() == list(np.argsort(np.argsort(
        table.column("x").to_numpy()[:200])) + 1)


# --------------------------------------------------------------------------
# the rank-limit pushdown (WindowGroupLimitExec)
# --------------------------------------------------------------------------

def _wgl_table(n=8000, groups=40):
    rng = np.random.default_rng(7)
    return pa.table({"g": rng.integers(0, groups, n), "v": rng.random(n),
                     "u": np.arange(n, dtype=np.int64)})


def _explains(table, query, conf=None):
    """(port explain, reference explain) of the same query."""
    jsess = jsrt.session(conf=RapidsConf.get_global().copy(conf or {}))
    sess = srt.session(device="cpu", conf=conf)
    return (sess.explain(query(sess.create_dataframe(table, num_partitions=4),
                               F, Window)),
            jsess.explain(query(jsess.create_dataframe(table,
                                                       num_partitions=4),
                                JF, JWindow)))


def _top(kind, op, k, extra=None):
    def query(df, F, Window):
        w = Window.partitionBy("g").orderBy(F.col("v").desc())
        df = df.withColumn("r", getattr(F, kind)().over(w))
        if extra is not None:
            df = extra(df, F, w)
        r = F.col("r")
        return df.filter(r <= k if op == "<=" else r < k)
    return query


def _lead_too(df, F, w):
    return df.withColumn("nxt", F.lead(F.col("v")).over(w))


def _sum_instead(df, F, w):
    return df.withColumn("r", F.sum(F.col("v")).over(w))


@pytest.mark.parametrize("kind,op,k,extra,planned", [
    ("row_number", "<=", 5, None, True),
    ("rank", "<=", 3, None, True),
    ("dense_rank", "<=", 2, None, True),
    ("row_number", "<", 3, None, True),
    ("row_number", "<=", 3, _lead_too, False),     # mixed functions
    ("row_number", "<=", 2, _sum_instead, False),  # no rank function
])
def test_window_group_limit_planned_as_in_reference_and_exact(
        kind, op, k, extra, planned):
    query = _top(kind, op, k, extra)
    mine, theirs = _explains(_wgl_table(), query, {MIN_ROWS: 0})
    assert ("WindowGroupLimit" in mine) == ("WindowGroupLimit" in theirs) \
        == planned
    got, ref, sess = _run_both(_wgl_table(), query, {MIN_ROWS: 0}, 4)
    _assert_match(got, ref, summed={"r"} if extra is _sum_instead else ())
    if planned:
        # below the exchange: each map partition's top rows only
        (wgl,) = _find(sess.last_plan, WindowGroupLimitExec)
        (ex,) = _find(sess.last_plan, ShuffleExchangeExec)
        assert _find(ex, WindowGroupLimitExec) == [wgl]
        assert ex.rows_partitioned < 8000


def test_window_group_limit_keeps_tied_top_rows():
    table = pa.table({"g": [1, 1, 1, 1, 2, 2],
                      "v": [5.0, 5.0, 4.0, 3.0, 9.0, 9.0],
                      "u": list(range(6))})
    got, ref, sess = _run_both(table, _top("rank", "<=", 1), None, 2)
    assert "WindowGroupLimitExec" in sess.explain()
    _assert_match(got, ref)
    assert sorted(got.column("v").tolist()) == [5.0, 5.0, 9.0, 9.0]


def test_window_group_limit_does_not_leak_to_unfiltered_plan():
    table = _wgl_table(2000, 10)
    sess = srt.session(device="cpu")
    w = Window.partitionBy("g").orderBy(F.col("v").desc())
    base = sess.create_dataframe(table, num_partitions=4).withColumn(
        "r", F.row_number().over(w))
    top = base.filter(F.col("r") <= 5)
    assert "WindowGroupLimitExec" in sess.explain(top)
    assert top.collect().num_rows == 50
    assert base.collect().num_rows == 2000
    assert "WindowGroupLimitExec" not in sess.explain(base)


def test_window_group_limit_not_planned_for_a_shared_unfiltered_branch():
    """One Window under a rank filter in one branch and unfiltered in the
    other (here the two sides of a join) keeps every row."""
    def query(df, F, Window):
        w = Window.partitionBy("g").orderBy(F.col("v").desc())
        base = df.withColumn("r", F.row_number().over(w))
        top = base.filter(F.col("r") <= 2)
        other = base.select(F.col("u").alias("u2"), F.col("g").alias("g2"))
        return other.join(top, other["u2"] == top["u"], "left").select(
            F.col("u2").alias("u"), "g2", "r")
    table = _wgl_table(1000, 5)
    mine, theirs = _explains(table, query)
    assert "WindowGroupLimit" not in mine
    assert "WindowGroupLimit" not in theirs
    got, ref, _ = _run_both(table, query, None, 4)
    assert got.num_rows == 1000
    assert int((~np.ma.getmaskarray(got.column("r"))).sum()) == 10
    _assert_match(got, ref)


# --------------------------------------------------------------------------
# the slice's two paths, scaled down
# --------------------------------------------------------------------------

def bench_window_table(rows, seed=8):
    """bench.py's window shape: k in [0, max(rows // 1000, 8)), t a
    permutation of the rows, v random doubles."""
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, max(rows // 1000, 8), rows),
                     "t": rng.permutation(rows), "v": rng.random(rows)})


def running_sum(df, F, Window):
    w = Window.partitionBy("k").orderBy("t")
    return df.withColumn("rs", F.sum(F.col("v")).over(w))


def path1(df, F, Window):
    return running_sum(df, F, Window).agg(F.sum(F.col("rs")).alias("total"))


@pytest.mark.parametrize("num_partitions", [1, 4])
def test_bench_window_path_matches_reference_and_numpy(num_partitions):
    table = bench_window_table(20_000)
    conf = {MIN_ROWS: 0}
    got, ref, sess = _run_both(table, running_sum, conf, num_partitions)
    _assert_match(got, ref, sort_by=("t",), summed={"rs"})
    if num_partitions > 1:
        (ex,) = _find(sess.last_plan, ShuffleExchangeExec)
        assert ex.coalesced is False and ex.rows_partitioned == 20_000
    # numpy: rows sorted by (k, t), a cumsum inside each key
    k, t, v = (table.column(c).to_numpy() for c in ("k", "t", "v"))
    order = np.lexsort((t, k))
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    rs = np.empty(v.size)
    for a, b in zip(starts, np.r_[starts[1:], ks.size]):
        rs[order[a:b]] = np.cumsum(v[order[a:b]])
    # rows match by t, a permutation of the row numbers
    got_rs = np.empty(v.size)
    got_rs[got.column("t")] = got.column("rs")
    want = np.empty(v.size)
    want[t] = rs
    # the port's frame sum subtracts two prefix sums of its batch: its error
    # scales with the prefix (at most the sum of |v|), not with rs
    np.testing.assert_allclose(got_rs, want, rtol=RTOL_SUM,
                               atol=RTOL_SUM * np.abs(v).sum())
    total, ref_total, _ = _run_both(table, path1, conf, num_partitions)
    np.testing.assert_allclose(total.column("total"), [rs.sum()],
                               rtol=RTOL_SUM)
    _assert_match(total, ref_total, sort_by=("total",), summed={"total"})


def test_bench_window_global_sum_goes_to_both_seg_sum_builds(monkeypatch):
    """The partial of agg(sum(rs)) has no keys and a one-row table: its
    flag and count slots go to seg_sum_f32, the double sum to
    seg_sum_f64."""
    calls = {"seg_sum_f32": [], "seg_sum_f64": []}
    for name in calls:
        launch = getattr(K, name)

        def record(vals, rank, out_size, _name=name, _launch=launch):
            calls[_name].append((vals.dtype, tuple(vals.shape), out_size))
            return _launch(vals, rank, out_size)
        monkeypatch.setattr(K, name, record)
    sess = srt.session(device="cpu", conf={MIN_ROWS: 0})
    path1(sess.create_dataframe(bench_window_table(5000), num_partitions=4),
          F, Window).collect()
    # one partial per reduce partition of the window's exchange: the sum
    # slot in seg_sum_f64; the any-valid flags and the count in seg_sum_f32
    assert 1 <= len(calls["seg_sum_f64"]) <= 4
    assert len(calls["seg_sum_f32"]) == 2 * len(calls["seg_sum_f64"])
    assert {(dt, shape[0], out) for dt, shape, out in calls["seg_sum_f64"]} \
        == {(torch.float64, 1, 1)}
    assert {(dt, shape[0], out) for dt, shape, out in calls["seg_sum_f32"]} \
        == {(torch.float32, 2, 1), (torch.float32, 1, 1)}


def rank_top_line(df, F, Window):
    w = Window.partitionBy("l_orderkey").orderBy(F.col("l_quantity").desc())
    return df.withColumn("r", F.rank().over(w)).filter(F.col("r") <= 1)


@pytest.mark.parametrize("num_partitions", [1, 4])
def test_top_line_per_order_matches_reference_and_numpy(num_partitions):
    table = lineitem(3000)
    table = table.append_column("u", pa.array(np.arange(table.num_rows)))
    got, ref, sess = _run_both(table, rank_top_line, {MIN_ROWS: 0},
                               num_partitions)
    _assert_match(got, ref)
    plan = sess.explain()
    assert "WindowGroupLimitExec [rank <= 1]" in plan
    if num_partitions > 1:
        (ex,) = _find(sess.last_plan, ShuffleExchangeExec)
        assert _find(ex, WindowGroupLimitExec)
    keys = table.column("l_orderkey").to_numpy()
    qty = table.column("l_quantity").to_numpy()
    uk, inv = np.unique(keys, return_inverse=True)
    best = np.full(uk.size, -np.inf)
    np.maximum.at(best, inv, qty)
    keep = qty == best[inv]
    order = np.argsort(got.column("u"))
    np.testing.assert_array_equal(got.column("u")[order],
                                  np.nonzero(keep)[0])
    np.testing.assert_array_equal(got.column("r")[order], 1)


# --------------------------------------------------------------------------
# min and max in groupBy().agg
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def min_max_table():
    """The min/max cases' table, built once for the three keys."""
    rng = np.random.default_rng(21)
    n = 3000
    days = rng.integers(0, 2000, n).astype("datetime64[D]")
    return pa.table({
        "ki": pa.array(rng.integers(0, 50, n), mask=rng.random(n) < 0.05),
        "kd": pa.array(rng.integers(0, 50, n) / 4.0,
                       mask=rng.random(n) < 0.05),
        "kt": pa.array(days[rng.integers(0, 50, n)],
                       mask=rng.random(n) < 0.05),
        "i": pa.array(rng.integers(-99, 99, n).astype(np.int32),
                      mask=rng.random(n) < 0.2),
        "l": pa.array(rng.integers(-1 << 40, 1 << 40, n)),
        "x": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2),
        "d": pa.array(days, mask=rng.random(n) < 0.2)})


@pytest.mark.parametrize("key", ["ki", "kd", "kt"])
def test_groupby_min_max_match_reference(min_max_table, key):
    table = min_max_table

    def query(df, F, Window):
        return (df.groupBy(key)
                .agg(F.min("i").alias("min_i"), F.max("i").alias("max_i"),
                     F.min("l").alias("min_l"), F.max("x").alias("max_x"),
                     F.min("x").alias("min_x"), F.min("d").alias("min_d"),
                     F.max("d").alias("max_d"))
                .orderBy(key))
    for parts, conf in ((1, {}), (3, {MIN_ROWS: 0})):
        got, ref, _ = _run_both(table, query, conf, parts)
        assert got.num_rows == ref.num_rows == 51
        got_d = got.column("min_d")
        assert got_d.dtype == np.dtype("datetime64[D]")
        _assert_match(got, ref, sort_by=())   # both ordered by the key


# --------------------------------------------------------------------------
# decimal windows through the DataFrame API
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["decimal(12,2)", "decimal(38,10)"])
def test_decimal_range_and_rows_frames_follow_python(dtype):
    """Windowed sum, avg, min and max over a decimal in running and sliding
    ROWS frames, and a RANGE frame over the decimal order key whose offset
    is scaled to the key (ROADMAP: the offset of 1 over 3.00 reaches
    2.00), held to Python's ``decimal``."""
    import decimal
    D = decimal.Decimal
    rng = np.random.default_rng(17)
    n = 240
    vals = [None if rng.random() < 0.1 else
            D(int(x)).scaleb(-2) for x in rng.integers(-5000, 5000, n)]
    sess = srt.session(device="cpu")
    t = pa.table({"u": np.arange(n), "k": rng.integers(0, 4, n),
                  "d0": pa.array(vals, pa.decimal128(12, 2))})
    df = sess.create_dataframe(t, num_partitions=2).select(
        "u", "k", F.col("d0").cast(dtype).alias("d"))
    wr = Window.partitionBy("k").orderBy("u")
    wd = Window.partitionBy("k").orderBy("d")
    got = df.select(
        "u", "k", "d", F.sum("d").over(wr).alias("run"),
        F.avg("d").over(wr.rowsBetween(-2, 1)).alias("avg"),
        F.min("d").over(wr.rowsBetween(-3, 0)).alias("mn"),
        F.max("d").over(wr.rowsBetween(-1, 1)).alias("mx"),
        F.count("d").over(wd.rangeBetween(-1, 0)).alias("rc")
    ).collect().to_pylist()
    scale = 2 if dtype == "decimal(12,2)" else 10
    ctx = decimal.Context(prec=80)
    parts = {}
    for r in sorted(got, key=lambda r: r["u"]):
        parts.setdefault(r["k"], []).append(r)
    for part in parts.values():
        for i, r in enumerate(part):
            def live(rows):
                return [x["d"] for x in rows if x["d"] is not None]
            run = live(part[:i + 1])
            assert r["run"] == (sum(run) if run else None)
            win = live(part[max(0, i - 2):i + 2])
            want = None if not win else (ctx.divide(sum(win), len(win))
                                         ).quantize(D(1).scaleb(-scale - 4),
                                                    decimal.ROUND_HALF_UP)
            assert r["avg"] == want, r
            mn = live(part[max(0, i - 3):i + 1])
            assert r["mn"] == (min(mn) if mn else None)
            mx = live(part[max(0, i - 1):i + 2])
            assert r["mx"] == (max(mx) if mx else None)
            if r["d"] is not None:
                assert r["rc"] == sum(1 for x in part if x["d"] is not None
                                      and r["d"] - 1 <= x["d"] <= r["d"])
