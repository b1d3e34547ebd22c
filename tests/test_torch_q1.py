"""The q1 slice of the port (spark_rapids_tpu_torch) against the JAX
package, from the ops on the path up to the query end to end.  The same
inputs, made with numpy from a seed, go through both packages.

Tolerances: keys, counts, ids and permutations are exact; double sums and
averages agree to rtol=1e-9 (float64 summed in another order, ~n*eps at
these sizes); float32 sums to rtol=1e-4 (f32, another order, <= 20k terms)."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu as jsrt
import spark_rapids_tpu_torch as srt
from spark_rapids_tpu.columnar.convert import arrow_to_device as jax_upload
from spark_rapids_tpu.ops import segmented as JS
from spark_rapids_tpu.ops.hash_group import group_ids as jax_group_ids
from spark_rapids_tpu.ops.sorting import sort_permutation as jax_sort_perm
from spark_rapids_tpu.sql import functions as JF
from spark_rapids_tpu.sql.physical import aggregate as JA
from spark_rapids_tpu_torch.columnar import batch_from_reference
from spark_rapids_tpu_torch.ops import kernels as K
from spark_rapids_tpu_torch.ops import segmented as S
from spark_rapids_tpu_torch.ops.hash_group import group_ids
from spark_rapids_tpu_torch.ops.sorting import sort_permutation
from spark_rapids_tpu_torch.sql import functions as F
from spark_rapids_tpu_torch.sql.expressions.aggregates import (COUNT, MAX,
                                                               MIN, SUM)
from spark_rapids_tpu_torch.sql.physical import aggregate as A

ROWS = 20_000


def make_data(rows, seed=42):
    """bench.py make_data, at a test size."""
    rng = np.random.default_rng(seed)
    return {
        "returnflag": rng.integers(0, 3, rows).astype(np.int64),
        "linestatus": rng.integers(0, 2, rows).astype(np.int64),
        "quantity": (rng.random(rows) * 50).astype(np.float32),
        "extendedprice": (rng.random(rows) * 100_000).astype(np.float32),
        "discount": (rng.random(rows) * 0.1).astype(np.float32),
        "tax": (rng.random(rows) * 0.08).astype(np.float32),
    }


def q1(df, F):
    """The bench.py:288-305 query, for either package."""
    return (df.filter(df.quantity < 24.0)
            .withColumn("disc_price",
                        df.extendedprice * (1.0 - df.discount))
            .withColumn("charge",
                        df.extendedprice * (1.0 - df.discount)
                        * (1.0 + df.tax))
            .groupBy("returnflag", "linestatus")
            .agg(F.sum(F.col("quantity")).alias("sum_qty"),
                 F.sum(F.col("extendedprice")).alias("sum_base"),
                 F.sum(F.col("disc_price")).alias("sum_disc_price"),
                 F.sum(F.col("charge")).alias("sum_charge"),
                 F.avg(F.col("quantity")).alias("avg_qty"),
                 F.avg(F.col("extendedprice")).alias("avg_price"),
                 F.avg(F.col("discount")).alias("avg_disc"),
                 F.count("*").alias("count"))
            .orderBy("returnflag", "linestatus"))


def _assert_tables_match(got, ref: pa.Table):
    assert got.column_names == ref.column_names
    for name, ref_col in zip(ref.column_names, ref.columns):
        g = got.column(name)
        r = ref_col.to_numpy(zero_copy_only=False)
        np.testing.assert_array_equal(np.ma.getmaskarray(g),
                                      np.asarray(ref_col.is_null()), name)
        valid = ~np.ma.getmaskarray(g)
        if np.issubdtype(g.dtype, np.floating):
            np.testing.assert_allclose(g.data[valid], r[valid].astype(float),
                                       rtol=1e-9, err_msg=name)
        else:
            np.testing.assert_array_equal(g.data[valid], r[valid], name)


def _select(table, name):
    """One column of a port result, as a HostTable."""
    i = table.names.index(name)
    return type(table)([name], [table.types[i]], [table.datas[i]],
                       [table.validities[i]])


def _both(table):
    """One reference batch and its copy in the port."""
    ref = jax_upload(table)
    got = batch_from_reference(
        ref.names, [np.asarray(c.data) for c in ref.columns],
        [np.asarray(c.validity) for c in ref.columns], ref.num_rows_int,
        "cpu")
    return ref, got


def _key_table(rng, n, null_p=0.1):
    return pa.table({
        "k1": pa.array(rng.integers(0, 4, n), mask=rng.random(n) < null_p),
        "k2": pa.array(rng.integers(-2, 1, n).astype(np.int32),
                       mask=rng.random(n) < null_p),
        "d": pa.array(rng.standard_normal(n) * 1e3,
                      mask=rng.random(n) < null_p),
        "f": pa.array(rng.random(n).astype(np.float32),
                      mask=rng.random(n) < null_p),
        "m": pa.array(rng.integers(-100, 100, n),
                      mask=rng.random(n) < null_p),
    })


# --------------------------------------------------------------------------
# ops on the path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 900, 5000])
def test_group_ids_match_reference(rng, n):
    ref, got = _both(_key_table(rng, n))
    want = np.asarray(jax_group_ids(jnp, list(ref.columns[:2]),
                                    ref.row_mask()))
    ids = group_ids(list(got.columns[:2]), got.row_mask())
    np.testing.assert_array_equal(ids.numpy(), want)


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False)])
def test_sort_permutation_matches_reference(rng, asc, nulls_first):
    ref, got = _both(_key_table(rng, 700))
    want = np.asarray(jax_sort_perm(
        jnp, [(c, asc, nulls_first) for c in ref.columns[:2]],
        ref.row_mask()))
    perm = sort_permutation([(c, asc, nulls_first) for c in got.columns[:2]],
                            got.row_mask())
    np.testing.assert_array_equal(perm.numpy(), want)


def test_segmented_ops_match_reference_and_drop_out_of_range(rng):
    n, num = 4000, 7
    ids = rng.integers(-3, num + 3, n).astype(np.int32)
    d2 = rng.standard_normal((n, 3))
    i2 = rng.integers(-50, 50, (n, 2))
    t_ids = torch.from_numpy(ids)
    np.testing.assert_allclose(
        S.seg_sum2(torch.from_numpy(d2), t_ids, num).numpy(),
        np.asarray(JS.seg_sum2(jnp, jnp.asarray(d2), jnp.asarray(ids), num)),
        rtol=1e-12)
    for mine, theirs, init in [(S.seg_min2, JS.seg_min2, 10**6),
                               (S.seg_max2, JS.seg_max2, -10**6)]:
        np.testing.assert_array_equal(
            mine(torch.from_numpy(i2), t_ids, num, init).numpy(),
            np.asarray(theirs(jnp, jnp.asarray(i2), jnp.asarray(ids), num,
                              init)))
    mask = rng.random(n) < 0.5
    np.testing.assert_array_equal(
        S.seg_count(torch.from_numpy(mask), t_ids, num).numpy(),
        np.asarray(JS.seg_count(jnp, jnp.asarray(mask), jnp.asarray(ids),
                                num)))
    np.testing.assert_array_equal(
        S.seg_min(torch.from_numpy(i2[:, 0]), t_ids, num, 999).numpy(),
        np.asarray(JS.seg_min(jnp, jnp.asarray(i2[:, 0]), jnp.asarray(ids),
                              num, 999)))


# --------------------------------------------------------------------------
# groupby_reduce on one batch carried across
# --------------------------------------------------------------------------

def test_groupby_reduce_matches_reference_device_branch(rng, monkeypatch):
    # the JAX package batches its slots only off the CPU; force that branch,
    # which is the one the port follows (its docstring allows this)
    monkeypatch.setattr(JA, "_use_batched_reduce", lambda xp: True)
    ref, got = _both(_key_table(rng, 6000))
    ops = [SUM, COUNT, SUM, MIN, MAX]
    slot_idx = [2, 2, 3, 4, 4]

    def slots(batch):
        return [(batch.columns[i], batch.columns[i].validity)
                for i in slot_idx]

    rank64, ng = JA.group_phase(jnp, list(ref.columns[:2]), ref.row_mask())
    out = int(ng)
    jk, js, jn = JA.groupby_reduce(jnp, list(ref.columns[:2]), slots(ref),
                                   ops, ref.row_mask(), rank64=rank64,
                                   n_groups=ng, out_size=out)
    K.reset_launches()
    t_rank, t_ng = A.group_phase(list(got.columns[:2]), got.row_mask())
    assert int(t_ng) == out
    np.testing.assert_array_equal(t_rank.numpy(), np.asarray(rank64))
    gk, gs, gn = A.groupby_reduce(list(got.columns[:2]), slots(got), ops,
                                  got.row_mask(), rank64=t_rank,
                                  n_groups=t_ng, out_size=out)
    assert int(gn) == int(jn) == out
    assert K.LAUNCHES["seg_sum_f32"] == 0        # the CPU takes the plain path
    for mine, theirs in zip(gk + gs, jk + js):
        v = np.asarray(theirs.validity)
        np.testing.assert_array_equal(mine.validity.numpy(), v)
        a, b = mine.data.numpy()[v], np.asarray(theirs.data)[v]
        assert mine.data.numpy().dtype == np.asarray(theirs.data).dtype
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-4)
        elif a.dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=1e-9)
        else:
            np.testing.assert_array_equal(a, b)


def _recording(monkeypatch, name):
    """Record the values of every call of ``K.<name>`` (then run it)."""
    calls = []
    launch = getattr(K, name)

    def record(values, rank, out_size):
        calls.append((values.dtype, tuple(values.shape), int(out_size)))
        return launch(values, rank, out_size)
    monkeypatch.setattr(K, name, record)
    return calls


def test_groupby_reduce_sends_double_sums_to_the_f64_kernel(rng,
                                                           monkeypatch):
    _, got = _both(_key_table(rng, 3000))
    f64 = _recording(monkeypatch, "seg_sum_f64")
    f32 = _recording(monkeypatch, "seg_sum_f32")
    ops = [SUM, SUM, COUNT, SUM, MIN, MAX, SUM]
    slot_idx = [2, 4, 2, 3, 2, 2, 2]     # double, long, -, float, -, -, double
    slots = [(got.columns[i], got.columns[i].validity) for i in slot_idx]
    keys = list(got.columns[:2])
    rank, ng = A.group_phase(keys, got.row_mask())
    out = int(ng)
    gk, gs, _ = A.groupby_reduce(keys, slots, ops, got.row_mask(),
                                 rank64=rank, n_groups=ng, out_size=out)
    # the two double SUM slots in one launch over the batch's capacity; the
    # long SUM stays exact on seg_sum2; the 7 any-valid flags, the count and
    # the float SUM on the f32 build
    cap = got.row_mask().shape[0]
    assert f64 == [(torch.float64, (2, cap), out)]
    assert [c[1][0] for c in f32] == [7, 1, 1]
    assert gs[3].data.dtype == torch.float32
    # the same sums as seg_sum2 gives them
    rank32 = rank.to(torch.int32)
    for i in (0, 6):
        col, contrib = slots[i]
        vals = torch.where(contrib & got.row_mask(), col.data.double(), 0.0)
        want = S.seg_sum2(vals[:, None], rank32, out)[:, 0]
        np.testing.assert_allclose(gs[i].data.numpy(), want.numpy(),
                                   rtol=1e-12)
    want_long = S.seg_sum2(torch.where(slots[1][1] & got.row_mask(),
                                       slots[1][0].data, 0)[:, None],
                           rank32, out)[:, 0]
    assert gs[1].data.dtype == torch.int64
    assert torch.equal(gs[1].data, want_long)


@pytest.mark.parametrize("groups", [K.SEG_SUM_MAX_GROUPS + 1, None])
def test_groupby_reduce_keeps_large_tables_and_the_merge_on_seg_sum2(
        rng, monkeypatch, groups):
    n = 2000
    table = pa.table({"k": pa.array(np.arange(n) % 300),
                      "d": pa.array(rng.standard_normal(n))})
    _, got = _both(table)
    f64 = _recording(monkeypatch, "seg_sum_f64")
    keys = [got.columns[0]]
    slots = [(got.columns[1], got.columns[1].validity)]
    rank, ng = A.group_phase(keys, got.row_mask())
    assert int(ng) == 300
    # above 256 groups, or the final merge's table (no host-sized table)
    out_size = None if groups is None else int(ng)
    _, gs, _ = A.groupby_reduce(keys, slots, [SUM], got.row_mask(),
                                rank64=rank, n_groups=ng, out_size=out_size)
    assert f64 == []
    want = np.bincount(np.arange(n) % 300,
                       weights=table.column("d").to_numpy())
    np.testing.assert_allclose(gs[0].data.numpy()[:300], want, rtol=1e-12)


# --------------------------------------------------------------------------
# the query end to end
# --------------------------------------------------------------------------

def _run_both(table, query):
    ref = query(jsrt.session().create_dataframe(table), JF).collect()
    got = query(srt.session(device="cpu").create_dataframe(table),
                F).collect()
    return got, ref


def test_q1_matches_reference():
    got, ref = _run_both(pa.table(make_data(ROWS)), q1)
    assert got.num_rows == ref.num_rows == 6
    _assert_tables_match(got, ref)


def test_q1_on_numpy_input_equals_arrow_input():
    data = make_data(5000, seed=7)
    a = q1(srt.session(device="cpu").create_dataframe(data), F).collect()
    b = q1(srt.session(device="cpu").create_dataframe(pa.table(data)),
           F).collect()
    assert a.to_pylist() == b.to_pylist()


def test_q1_with_nulls_in_quantity_and_a_key_matches_reference():
    rng = np.random.default_rng(3)
    data = make_data(ROWS, seed=11)
    cols = {k: pa.array(v) for k, v in data.items()}
    cols["quantity"] = pa.array(data["quantity"],
                                mask=rng.random(ROWS) < 0.15)
    cols["returnflag"] = pa.array(data["returnflag"],
                                  mask=rng.random(ROWS) < 0.1)
    got, ref = _run_both(pa.table(cols), q1)
    assert got.num_rows == ref.num_rows == 8     # null returnflag groups
    assert got.column("returnflag").mask[:2].all()   # nulls first
    _assert_tables_match(got, ref)


def test_avg_and_sum_over_a_group_of_nulls_are_null():
    table = pa.table({"k": pa.array([1, 2, 2, 1, 3], pa.int64()),
                      "v": pa.array([1.5, None, None, 2.5, 4.0],
                                    pa.float32())})

    def query(df, F):
        return (df.groupBy("k")
                .agg(F.avg(F.col("v")).alias("a"),
                     F.sum(F.col("v")).alias("s"),
                     F.count("*").alias("n"))
                .orderBy("k"))
    got, ref = _run_both(table, query)
    _assert_tables_match(got, ref)
    assert got.to_pylist() == [
        {"k": 1, "a": 2.0, "s": 4.0, "n": 2},
        {"k": 2, "a": None, "s": None, "n": 2},
        {"k": 3, "a": 4.0, "s": 4.0, "n": 1}]


@pytest.mark.parametrize("rows", [0, 1000])
def test_global_aggregate_matches_reference(rows):
    data = make_data(rows, seed=5)

    def query(df, F):
        return df.filter(df.quantity < 24.0).agg(
            F.sum(F.col("extendedprice")).alias("s"),
            F.avg(F.col("discount")).alias("a"),
            F.count("*").alias("n"))
    got, ref = _run_both(pa.table(data), query)
    assert got.num_rows == ref.num_rows == 1     # one row even over no rows
    _assert_tables_match(got, ref)


def test_aggregate_expression_wrapper_is_transparent_and_distinct_raises():
    from spark_rapids_tpu_torch.sql.dataframe import Column
    from spark_rapids_tpu_torch.sql.expressions.aggregates import (
        AggregateExpression, Sum)
    df = srt.session(device="cpu").create_dataframe(make_data(3000, seed=9))
    wrapped = Column(AggregateExpression(Sum(df.tax.expr)))
    a = df.groupBy("linestatus").agg(wrapped.alias("s")).orderBy("linestatus")
    b = df.groupBy("linestatus").agg(F.sum(df.tax).alias("s")
                                     ).orderBy("linestatus")
    assert a.collect().to_pylist() == b.collect().to_pylist()
    distinct = Column(AggregateExpression(Sum(df.tax.expr), is_distinct=True))
    with pytest.raises(NotImplementedError, match="DISTINCT"):
        df.groupBy("linestatus").agg(distinct.alias("s")).collect()


def test_division_and_its_types_match_reference():
    table = pa.table({"k": pa.array([1, 1, 2, 2, 3], pa.int64()),
                      "i": pa.array([7, 2, 9, None, 4], pa.int32()),
                      "x": pa.array([1.5, 0.0, -2.0, 3.0, 0.0], pa.float32())})

    def query(df, F):
        return (df.withColumn("q", df.i / df.k)      # int / long -> double
                .withColumn("r", df.x / df.k)        # float / long -> float
                .withColumn("z", df.x / 0.0)         # IEEE: inf, nan
                .groupBy("k")
                .agg(F.sum(F.col("q")).alias("q"),
                     F.sum(F.col("r")).alias("r"),
                     F.sum(F.col("z")).alias("z"))
                .orderBy("k"))
    got, ref = _run_both(table, query)
    assert [t.simple_string() for t in got.types] == \
        ["bigint", "double", "double", "double"]
    for name in ("k", "q", "r"):
        _assert_tables_match(_select(got, name), ref.select([name]))
    np.testing.assert_array_equal(np.ma.getdata(got.column("z")),
                                  ref.column("z").to_numpy())
