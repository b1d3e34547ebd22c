"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one NVIDIA
card: the quickest proof that the port starts, builds its kernels and answers
its main paths on the GPU.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1 and 2, and each kernel alone
                                      # at q1's shapes; no result line

Phases (any failure exits non-zero, and no result line is printed):
1. device: the card's name, power limit and the torch/CUDA versions; build
   every hand-written kernel from the sources in the checkout, one nvcc per
   source, all started together; print what ptxas reports for each
   seg_sum instantiation and fail on any spill;
2. kernels against their plain PyTorch versions on the card, at the shapes of
   the main paths and at the edges: seg_sum_f32 and seg_sum_f64 (out_size
   1, 6, 8, 9 and 256 on both sides of the small-table limit; n = 0, 1, 3,
   2^21 + 3 and 2^23; dead rows at the end or scattered, negative and
   too-large ranks; a misaligned input; exact on 0/1 flags and on
   integer-valued doubles, float32 within RTOL_F32 of a float64 sum, float64
   within RTOL_F64_KERNEL of the plain version; a rerun gives the same bits)
   and murmur3_long (bit for bit, scalar and per-row seeds, n from 0 to
   6,000,000, int64 edge values);
3. the main paths, each through session() -> create_dataframe -> ... ->
   collect() on cuda and held against a numpy oracle, each with every launch
   count set to 0 just before it and read just after:
   a. q1 (the bench.py query: filter, two double projections, group by two
      int64 keys with 4 sums, 3 averages and a count, order by) over
      8,000,000 rows in one partition; seg_sum_f32 (flags and counts) and
      seg_sum_f64 (the 7 double sums) must launch;
   b. the same q1 at 4 partitions with the default configuration (AQE
      coalesces both exchanges; both seg_sum builds run in each map's
      partial) and with spark.sql.adaptive.enabled=false (a two-key hash
      exchange with chained per-row seeds, then a range exchange);
      murmur3_long must launch in the second, and every one of its calls
      there is then held bit for bit against the plain version at its own
      input; every seg_sum call of each q1 run is replayed against the
      plain version the same way (exact on flags, RTOL_F64_KERNEL on
      double sums);
   c. TPC-H Q18's inner aggregate at scale factor 1 (1,500,000 orders, about
      6.0M lineitem rows, 4 partitions): group by l_orderkey, sum(l_quantity)
      > 300, order by; keys and sums exact; its hash exchange must not
      coalesce, murmur3_long must launch, and each of its calls (the
      partial rows of one map, scalar seed 42) is then held bit for bit
      against the plain version at its own input;
   d. repartition(8, "l_orderkey") over the same lineitem, the planned
      exchange executed per partition: every row once, every row in the
      partition pmod(murmur3(key, 42), 8) of the plain version; and
      withColumn("h", hash("l_orderkey")) equal to the plain version;
4. times: warm q1 at one and at four partitions and warm Q18-inner (median
   of 5 each), a profile of one warm q1 (which must show no float64
   index_add_ kernel) and one warm Q18-inner, and for each kernel on the
   inputs its main path gave it: the kernel, its plain version, one library
   call computing the same function where there is one (for seg_sum the
   better of index_add_ on the [s, n] and on the [n, s] layout), and the
   bound that the card's bandwidth sets.

The last two lines before the final one are the ``kernels`` JSON line and the
card as ``nvidia-smi`` names it; the final line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np

ROWS = 8_000_000
SEED = 42
#: TPC-H scale factor 1: orders in the ORDERS table (spec 4.2.5)
SF1_ORDERS = 1_500_000
#: the kernels of the port, by source file under spark_rapids_tpu_torch/csrc
KERNEL_SOURCES = ("seg_sum", "murmur3")
#: published peak of one H100 SXM (NVIDIA data sheet): HBM bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: rtol of float64 results against the numpy oracle: the sums run in another
#: order, at most ~n*eps ~ 1e-9 relative at 2^23 terms
RTOL_F64 = 1e-9
#: rtol of float32 sums (kernel and plain) against a float64 sum of the same
#: float32 inputs, at n = 65,536; the kernel's blocked sums hold it at every
#: shape of phase 2
RTOL_F32 = 1e-5
#: rtol of the float64 seg-sum kernel against its plain version on positive
#: values: both sum in float64, in other orders (the plain one with atomics)
RTOL_F64_KERNEL = 1e-12
#: the seg-sum kernel's small-table limit (kSmallGroups in csrc/seg_sum.cu)
SEG_SUM_SMALL_GROUPS = 8
#: the seg-sum builds: kernel name -> torch dtype name
SEG_SUM_BUILDS = {"seg_sum_f32": "float32", "seg_sum_f64": "float64"}


def log(*parts):
    print(*parts, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def make_data(rows: int):
    """bench.py make_data: lineitem-like columns from seed 42."""
    rng = np.random.default_rng(SEED)
    return {
        "returnflag": rng.integers(0, 3, rows).astype(np.int64),
        "linestatus": rng.integers(0, 2, rows).astype(np.int64),
        "quantity": (rng.random(rows) * 50).astype(np.float32),
        "extendedprice": (rng.random(rows) * 100_000).astype(np.float32),
        "discount": (rng.random(rows) * 0.1).astype(np.float32),
        "tax": (rng.random(rows) * 0.08).astype(np.float32),
    }


def q1(df, F):
    """bench.py:288-305."""
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


def q1_oracle(data):
    """Independent numpy q1: float64 arithmetic, bincount sums."""
    keep = data["quantity"] < 24.0
    rf, ls = data["returnflag"][keep], data["linestatus"][keep]
    qty = data["quantity"][keep].astype(np.float64)
    price = data["extendedprice"][keep].astype(np.float64)
    disc = data["discount"][keep].astype(np.float64)
    tax = data["tax"][keep].astype(np.float64)
    disc_price = price * (1.0 - disc)
    charge = price * (1.0 - disc) * (1.0 + tax)
    code = rf * 2 + ls
    groups = np.unique(code)
    nb = int(code.max()) + 1

    def gsum(v):
        return np.bincount(code, weights=v, minlength=nb)[groups]
    cnt = np.bincount(code, minlength=nb)[groups]
    return {
        "returnflag": groups // 2, "linestatus": groups % 2,
        "sum_qty": gsum(qty), "sum_base": gsum(price),
        "sum_disc_price": gsum(disc_price), "sum_charge": gsum(charge),
        "avg_qty": gsum(qty) / cnt, "avg_price": gsum(price) / cnt,
        "avg_disc": gsum(disc) / cnt, "count": cnt,
    }


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            flush_l2: bool = False) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).
    With ``flush_l2`` each launch is timed alone after 256 MB are written,
    which evicts the 50 MB L2 (and keeps the card busy while the host
    enqueues ``fn``), so inputs that fit in L2 come from device memory as
    the main path finds them."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if flush_l2:
        scrap = torch.empty(1 << 26, dtype=torch.int32, device="cuda")
        ends = [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ends:
            scrap.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ends) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def spill_report(text: str):
    """(function, registers, spill store bytes, spill load bytes) for every
    kernel in a ptxas -v report."""
    import re
    found, fn = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = [m.group(1), None, None, None]
            found.append(fn)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn is not None:
            fn[2], fn[3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn[1] = int(m.group(1))
    return [tuple(f) for f in found]


def seg_sum_inputs(torch, g, dtype, exact: bool, s: int, n: int,
                   out_size: int, dead_at_end: bool, misaligned=False):
    """[s, n] values and int32[n] ranks on the card.  Ranks: with
    ``dead_at_end`` 46% live rows first and the dead rest (negative or past
    the table) after them, as FilterExec leaves q1's batch; else drawn from
    [-2, out_size + 3), dead rows scattered.  Values: 0/1 flags (float32) or
    integers in [-1000, 1000] (float64) when ``exact``, else uniform in
    [0, 1).  ``misaligned`` puts both at an offset of one element, so the
    kernel cannot take 16-byte loads."""
    dev = "cuda"
    if dead_at_end:
        n_live = n * 46 // 100
        dead = torch.randint(-3, 3, (n - n_live,), generator=g, device=dev,
                             dtype=torch.int32)
        rank = torch.cat([
            torch.randint(0, out_size, (n_live,), generator=g, device=dev,
                          dtype=torch.int32),
            torch.where(dead < 0, dead, dead + out_size)])
    else:
        rank = torch.randint(-2, out_size + 3, (n,), generator=g, device=dev,
                             dtype=torch.int32)
    if not exact:
        vals = torch.rand(s, n, generator=g, device=dev, dtype=dtype)
    elif dtype == torch.float32:
        vals = (torch.rand(s, n, generator=g, device=dev) < 0.5).float()
    else:
        vals = torch.randint(-1000, 1001, (s, n), generator=g, device=dev
                             ).to(dtype)
    if misaligned:
        vbuf = torch.empty(s * n + 1, dtype=dtype, device=dev)
        vbuf[1:].copy_(vals.reshape(-1))
        rbuf = torch.empty(n + 1, dtype=torch.int32, device=dev)
        rbuf[1:].copy_(rank)
        vals, rank = vbuf[1:].view(s, n), rbuf[1:]
    return vals, rank


def seg_sum_against_plain(K, torch, name: str, vals, rank, out_size: int,
                          exact: bool):
    """One seg_sum call on the card against its plain version: bit for bit
    when ``exact``, else float64 within RTOL_F64_KERNEL of the plain version
    and float32 within RTOL_F32 of a float64 sum; a second launch must give
    the same bits.  Returns (max abs error vs plain, max relative error vs
    the reference); raises on a mismatch."""
    a = getattr(K, name)(vals, rank, out_size)
    again = getattr(K, name)(vals, rank, out_size)
    b = getattr(K, name + "_plain")(vals, rank, out_size)
    torch.cuda.synchronize()
    label = (f"{name} s={vals.shape[0]} n={vals.shape[1]} "
             f"out_size={out_size}")
    if not torch.equal(a, again):
        raise AssertionError(f"{label}: a rerun gives other bits")
    err = float((a.double() - b.double()).abs().max())
    if exact:
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: kernel != plain on exact input "
                                 f"(max abs err {err})")
        return err, 0.0
    if vals.dtype == torch.float64:
        ref, rtol = b, RTOL_F64_KERNEL
    else:
        ref, rtol = K.seg_sum_f64_plain(vals.double(), rank, out_size), \
            RTOL_F32
    diff = (a.double() - ref).abs()
    rel = float(torch.where(ref != 0, diff / ref.abs(), diff).max())
    if rel > rtol:
        raise AssertionError(f"{label}: max relative error {rel} > {rtol}")
    return err, rel


def check_seg_sum(K, torch) -> None:
    """Both seg_sum builds against their plain versions on the card, at
    every shape of the matrix in the module docstring."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    small = SEG_SUM_SMALL_GROUPS
    for name, dtype_name in SEG_SUM_BUILDS.items():
        dtype = getattr(torch, dtype_name)
        s_main = 11 if dtype == torch.float32 else 7   # two slot chunks
        cases = [(s_main, n, out_size, dead_at_end, False)
                 for out_size in (1, 6, small, small + 1, 256)
                 for n in (0, 1, 3, (1 << 21) + 3, 1 << 23)
                 for dead_at_end in (True, False)]
        cases += [(1, (1 << 21) + 3, 6, False, False),       # one slot
                  (s_main, 1 << 21, 6, False, True),         # misaligned
                  (s_main, 1 << 21, small + 1, True, True)]
        if dtype == torch.float32:   # q1's flag and count calls
            cases += [(15, 1 << 23, 6, True, False), (8, 1 << 23, 6, True, False)]
        for exact in (True, False):
            worst, worst_rel = 0.0, 0.0
            for s, n, out_size, dead_at_end, misaligned in cases:
                vals, rank = seg_sum_inputs(torch, g, dtype, exact, s, n,
                                            out_size, dead_at_end, misaligned)
                err, rel = seg_sum_against_plain(K, torch, name, vals, rank,
                                                 out_size, exact)
                worst, worst_rel = max(worst, err), max(worst_rel, rel)
                del vals, rank
            kind = ("0/1 flags" if dtype == torch.float32 else
                    "integer-valued doubles") if exact else "random values"
            log(f"  {name} on {kind}: {len(cases)} shapes, "
                + ("bit for bit, " if exact else
                   f"max_rel_err={worst_rel} (limit "
                   f"{RTOL_F64_KERNEL if dtype == torch.float64 else RTOL_F32}), ")
                + f"max_abs_err vs plain={worst}, reruns bit for bit")
    # random float32 at a small n: the plain version within RTOL_F32 too
    n = 65_536
    rank = torch.randint(0, 6, (n,), generator=g, device="cuda",
                         dtype=torch.int32)
    vals = torch.rand(4, n, generator=g, device="cuda")
    ref = K.seg_sum_f64_plain(vals.double(), rank, 6)
    for label, fn in (("kernel", K.seg_sum_f32),
                      ("plain", K.seg_sum_f32_plain)):
        rel = float(((fn(vals, rank, 6).double() - ref).abs()
                     / ref.abs()).max())
        log(f"  seg_sum_f32 random f32 n={n}: {label} max_rel_err={rel}")
        if rel > RTOL_F32:
            raise AssertionError(f"seg_sum_f32 random f32: {label} off by "
                                 f"{rel}")


def check_seg_sum_calls(K, torch, name: str, label: str, calls) -> float:
    """A seg_sum build against its plain version on every call a main path
    made, at its own inputs: bit for bit where the values are integers (the
    0/1 flags and counts), else as seg_sum_against_plain; returns the max
    abs error.  These launches come after the path's counts were read."""
    worst, worst_rel = 0.0, 0.0
    for vals, rank, out_size in calls:
        exact = bool((vals == vals.round()).all())
        err, rel = seg_sum_against_plain(K, torch, name, vals, rank,
                                         out_size, exact)
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    shapes = sorted({(int(v.shape[0]), int(v.shape[1]), int(o))
                     for v, _, o in calls})
    log(f"  {name} == plain on all {len(calls)} calls of {label} "
        f"((s, n, out_size) {shapes}; max_abs_err={worst}, "
        f"max_rel_err={worst_rel}; reruns bit for bit)")
    return worst


def check_murmur3(K, torch) -> float:
    """murmur3_long kernel vs plain on the card, bit for bit; returns the
    max abs error seen (0.0)."""
    rng = np.random.default_rng(SEED)
    i64 = np.iinfo(np.int64)
    edges = np.array([0, 1, -1, 1 << 31, -(1 << 31), 1 << 62, -(1 << 62),
                      i64.min, i64.max], dtype=np.int64)
    worst = 0.0
    for n in (0, 1, 127, (1 << 21) + 3, 6_000_000):
        vals = rng.integers(i64.min, i64.max, n, dtype=np.int64,
                            endpoint=True)
        k = min(n, edges.size)
        vals[:k] = edges[:k]
        v = torch.from_numpy(vals).cuda()
        seeds = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                                 .astype(np.uint32).view(np.int32)).cuda()
        for label, seed in (("seed 42", 42), ("per-row seeds", seeds)):
            a = K.murmur3_long(v, seed)
            b = K.murmur3_long_plain(v, seed)
            torch.cuda.synchronize()
            err = float((a.long() - b.long()).abs().max()) if n else 0.0
            worst = max(worst, err)
            log(f"  murmur3_long n={n} {label}: max_abs_err={err}")
            if a.dtype != torch.int32 or not torch.equal(a, b):
                raise AssertionError(f"murmur3_long n={n} {label}: kernel "
                                     "!= plain")
    return worst


def check_murmur3_calls(K, torch, label: str, calls) -> float:
    """murmur3_long kernel vs plain, bit for bit, on every call a main path
    made, at its own values and seeds; returns the max abs error (0.0).
    These launches come after the path's counts were read."""
    worst = 0.0
    for values, seed in calls:
        a = K.murmur3_long(values, seed)
        b = K.murmur3_long_plain(values, seed)
        torch.cuda.synchronize()
        n = values.shape[0]
        err = float((a.long() - b.long()).abs().max()) if n else 0.0
        worst = max(worst, err)
        form = "scalar" if isinstance(seed, int) else "per-row"
        if a.dtype != torch.int32 or not torch.equal(a, b):
            raise AssertionError(f"murmur3_long on {label}'s input n={n} "
                                 f"{form} seed: kernel != plain")
    sizes = sorted({int(v.shape[0]) for v, _ in calls})
    forms = sorted({"scalar" if isinstance(sd, int) else "per-row"
                    for _, sd in calls})
    log(f"  murmur3_long == plain, bit for bit, on all {len(calls)} calls "
        f"of {label} (n {sizes}, seeds {forms})")
    return worst


@contextmanager
def recording(K, name: str, calls: list):
    """Record the arguments of every call of ``K.<name>`` in ``calls``."""
    launch = getattr(K, name)

    def record(*args):
        calls.append(args)
        return launch(*args)
    setattr(K, name, record)
    try:
        yield
    finally:
        setattr(K, name, launch)


@contextmanager
def recording_seg_sums(K, calls: dict):
    """Record every call of both seg_sum builds: ``calls[name]`` lists the
    arguments of each call of ``K.<name>``."""
    with recording(K, "seg_sum_f32", calls.setdefault("seg_sum_f32", [])), \
            recording(K, "seg_sum_f64", calls.setdefault("seg_sum_f64", [])):
        yield


def drive(label: str, fn, K, torch, must_launch=()):
    """Run one main path with every launch count set to 0 just before it
    and read just after; fail if a kernel of ``must_launch`` did not
    launch.  Returns (result, launches, seconds)."""
    K.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"  {label}: {secs:.4f} s (cold); launches {launches}")
    for name in must_launch:
        if launches[name] < 1:
            raise AssertionError(f"{label} did not launch the {name} kernel")
    return out, launches, secs


def exchanges_of(phys):
    from spark_rapids_tpu_torch.sql.physical.exchange import \
        ShuffleExchangeExec
    found = [phys] if isinstance(phys, ShuffleExchangeExec) else []
    for c in phys.children:
        found.extend(exchanges_of(c))
    return found


def warm_ms(query, torch, runs: int = 5):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        query.collect()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def make_lineitem(n_orders: int):
    """Q18's lineitem columns, from seed 42: order keys sparse as TPC-H
    dbgen makes them (of every 32 key values the first 8 are used, spec
    4.2.3), 1-7 lines per order in key order, integer quantities 1..50 as
    float64 (the port has no decimal yet; testing/tpch_queries.py:92 of the
    JAX package makes the same choice).  Returns (columns, order keys,
    lines per order)."""
    rng = np.random.default_rng(SEED)
    o = np.arange(n_orders, dtype=np.int64)
    okeys = (o // 8) * 32 + o % 8 + 1
    lines = rng.integers(1, 8, n_orders)
    keys = np.repeat(okeys, lines)
    qty = rng.integers(1, 51, keys.size).astype(np.float64)
    return {"l_orderkey": keys, "l_quantity": qty}, okeys, lines


def q18_inner(df, F):
    """TPC-H Q18's inner aggregate: SELECT l_orderkey FROM lineitem GROUP BY
    l_orderkey HAVING sum(l_quantity) > 300, with the sum kept and ordered."""
    return (df.groupBy("l_orderkey")
            .agg(F.sum("l_quantity").alias("sum_qty"))
            .filter(F.col("sum_qty") > 300)
            .orderBy("l_orderkey"))


def q18_oracle(data, okeys, lines):
    sums = np.bincount(np.repeat(np.arange(okeys.size), lines),
                       weights=data["l_quantity"])
    keep = sums > 300
    return okeys[keep], sums[keep]


# --------------------------------------------------------------------------
# phases 3 and 4: the main path, and times
# --------------------------------------------------------------------------

def check_result(table, want, label: str = "q1") -> None:
    if table.num_rows != len(want["count"]):
        raise AssertionError(f"{label}: {table.num_rows} rows, want "
                             f"{len(want['count'])}")
    for name, w in want.items():
        col = table.column(name)
        if np.ma.getmaskarray(col).any():
            raise AssertionError(f"{label}: nulls in {name}")
        got = np.ma.getdata(col)
        if not np.all(np.isfinite(got)):
            raise AssertionError(f"{label}: non-finite values in {name}")
        if np.issubdtype(got.dtype, np.floating):
            np.testing.assert_allclose(got, w, rtol=RTOL_F64,
                                       err_msg=f"{label} {name}")
        else:
            np.testing.assert_array_equal(got, w, err_msg=f"{label} {name}")


def profile_query(label: str, query, torch, top: int = 12):
    """Where one warm collect spends device time: torch.profiler over it,
    device time by op, and the device's busy share of the wall time.
    Returns the float64 index_add_ kernels it saw, as (key, ms, count)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query.collect()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (kernels, copies): each is counted once
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type != torch.autograd.DeviceType.CPU),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"  profiled warm {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}; wall includes "
        "profiler overhead)")
    for e in kernels[:top]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    # the hand-written kernels, wherever they rank: device time alone,
    # without the host time of their wrappers
    for e in kernels:
        if "murmur3" in e.key or "seg_sum" in e.key:
            log(f"    hand kernel: {dev_us(e) / 1e3:.5f} ms  x{e.count} "
                f"{e.key[:100]}")
    # index_add_ runs as indexFuncSmallIndex / indexFuncLargeIndex<T, ...>
    f64_adds = [(e.key, dev_us(e) / 1e3, e.count) for e in kernels
                if "indexFunc" in e.key and "double" in e.key]
    for key, ms, count in f64_adds:
        log(f"    float64 index_add_: {ms:.3f} ms  x{count} {key[:100]}")
    log(f"    float64 index_add_ kernels: {len(f64_adds)}")
    return f64_adds


def seg_sum_times(K, torch, name: str, calls):
    """Per-run times of the calls of one seg_sum build that a main path
    made, each launch after an L2 flush.  ``library_ms`` is the better of two
    single PyTorch calls, each on inputs prepared outside the timed call:
    index_add_ along dim 1 of the kernel's [s, n] layout, and along dim 0 of
    the [n, s] layout that seg_sum2 uses."""
    kernel = getattr(K, name)
    plain = getattr(K, name + "_plain")
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  index_add_sn_ms=0.0, index_add_ns_ms=0.0)
    for values, rank, out_size in calls:
        s, n = values.shape
        live = (rank >= 0) & (rank < out_size)
        n_live = int(live.sum())
        idx = torch.where(live, rank, out_size).long()
        table_sn = torch.zeros(s, out_size + 1, dtype=values.dtype,
                               device=values.device)
        values_ns = values.T.contiguous()
        table_ns = torch.zeros(out_size + 1, s, dtype=values.dtype,
                               device=values.device)
        elem = values.element_size()
        t = dict(
            ms=cuda_ms(lambda: kernel(values, rank, out_size), flush_l2=True),
            plain_ms=cuda_ms(lambda: plain(values, rank, out_size), iters=5,
                             warmup=1, flush_l2=True),
            index_add_sn_ms=cuda_ms(
                lambda: table_sn.index_add_(1, idx, values), iters=5,
                warmup=1, flush_l2=True),
            index_add_ns_ms=cuda_ms(
                lambda: table_ns.index_add_(0, idx, values_ns),
                flush_l2=True),
            # every rank read once, the values of live rows only (a dead
            # row's values need not be read), the table written once
            bound_ms=(4 * n + elem * s * n_live + elem * s * out_size)
            / HBM_BYTES_PER_S * 1e3)
        t["library_ms"] = min(t["index_add_sn_ms"], t["index_add_ns_ms"])
        log(f"  {name} s={s} n={n} live={n_live} out_size={out_size}: " +
            ", ".join(f"{k}={v:.5f}" for k, v in t.items()))
        for k in totals:
            totals[k] += t[k]
        del values_ns, table_sn, table_ns, idx
    return totals


def seg_sum_alone(K, torch) -> None:
    """Each seg_sum build alone at q1's shapes (n = 2^23, out_size 6, 46%
    live rows first): f32 at s = 15 and 8 (flags and counts), f64 at s = 7
    (the double sums), each launch after an L2 flush, against the bound and
    index_add_ on [n, s]."""
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 2)
    for name, s in (("seg_sum_f32", 15), ("seg_sum_f32", 8),
                    ("seg_sum_f64", 7)):
        dtype = getattr(torch, SEG_SUM_BUILDS[name])
        vals, rank = seg_sum_inputs(torch, g, dtype, False, s, 1 << 23, 6,
                                    True)
        live = (rank >= 0) & (rank < 6)
        idx = torch.where(live, rank, 6).long()
        values_ns = vals.T.contiguous()
        table_ns = torch.zeros(7, s, dtype=dtype, device="cuda")
        bound = (4 * vals.shape[1] + vals.element_size() * s
                 * int(live.sum()) + vals.element_size() * s * 6) \
            / HBM_BYTES_PER_S * 1e3
        ms = cuda_ms(lambda: getattr(K, name)(vals, rank, 6), flush_l2=True)
        lib = cuda_ms(lambda: table_ns.index_add_(0, idx, values_ns),
                      flush_l2=True)
        log(f"  {name} alone s={s} n=2^23 out_size=6: kernel {ms:.5f} ms, "
            f"bound {bound:.5f} ms ({bound / ms:.1%}), index_add_ [n, s] "
            f"{lib:.5f} ms")


def murmur3_bytes(values, seed) -> int:
    """Bytes the function must move: 8 per value read, 4 per per-row seed
    read, 4 per hash written."""
    n = values.shape[0]
    return n * (16 if not isinstance(seed, int) else 12)


def murmur3_times(K, torch, calls):
    """Per-run times of the murmur3_long launches a main path made."""
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0)
    for values, seed in calls:
        t = dict(ms=cuda_ms(lambda: K.murmur3_long(values, seed)),
                 plain_ms=cuda_ms(lambda: K.murmur3_long_plain(values, seed)),
                 bound_ms=murmur3_bytes(values, seed) / HBM_BYTES_PER_S * 1e3,
                 bytes=murmur3_bytes(values, seed))
        log(f"  murmur3_long n={values.shape[0]} "
            f"{'scalar' if isinstance(seed, int) else 'per-row'} seed: " +
            ", ".join(f"{k}={v:.5f}" for k, v in t.items() if k != "bytes"))
        for k in totals:
            totals[k] += t[k]
    return totals


def run(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs "
                    "an NVIDIA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "spark_rapids_tpu_torch")):
        return fail(f"no spark_rapids_tpu_torch package beside {__file__}")
    sys.path.insert(0, root)
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.sql import functions as F

    # -- phase 1: device and build ------------------------------------------
    card = nvidia_smi_card()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    def timed_build(name):
        t0 = time.perf_counter()
        lib = K.build(name)
        return lib, time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        built = list(pool.map(timed_build, KERNEL_SOURCES))
    for lib, secs in built:
        log(f"built {lib.name} in {secs:.2f} s")
    log(f"all kernels built in {time.perf_counter() - t0:.2f} s")
    log("ptxas -v for csrc/seg_sum.cu:")
    for line in K.ptxas_report("seg_sum").splitlines():
        if line.strip():
            log(f"  {line.strip()}")
    for name in KERNEL_SOURCES:
        report = spill_report(K.ptxas_report(name))
        if not report:
            raise AssertionError(f"no ptxas report for {name}")
        for fn, regs, stores, loads in report:
            if stores or loads:
                raise AssertionError(f"{name}: {fn} spills ({stores} bytes "
                                     f"stored, {loads} loaded)")
        log(f"  {name}: {len(report)} kernels, registers "
            f"{sorted(r for _, r, _, _ in report)}, 0 spill bytes in each")

    # -- phase 2: kernels vs plain --------------------------------------------
    log("phase 2: kernels against their plain versions")
    check_seg_sum(K, torch)
    err = {"seg_sum_f32": 0.0, "seg_sum_f64": 0.0,
           "murmur3_long": check_murmur3(K, torch)}
    if "--kernels" in argv:
        log("phase 4 (kernels alone)")
        seg_sum_alone(K, torch)
        log("--kernels: phases 1 and 2 passed; the main paths were not run")
        return 0

    # -- phase 3: the main paths ----------------------------------------------
    sess = srt.session()
    if sess.device.type != "cuda":
        raise AssertionError(f"session() chose {sess.device}, not cuda")
    log(f"phase 3a: q1 over {ROWS} rows in one partition on cuda")
    data = make_data(ROWS)
    want = q1_oracle(data)
    query = q1(sess.create_dataframe(data), F)
    seg_calls: dict = {}
    with recording_seg_sums(K, seg_calls):
        table, q1_launches, _ = drive(
            "q1, one partition", query.collect, K, torch,
            list(SEG_SUM_BUILDS))
    for name in SEG_SUM_BUILDS:
        err[name] = max(err[name], check_seg_sum_calls(
            K, torch, name, "q1, one partition", seg_calls[name]))
    check_result(table, want)
    for row in table.to_pylist():
        log(f"  {row}")
    log("  q1 matches the numpy oracle (keys and counts exact, doubles "
        f"rtol={RTOL_F64})")

    log("phase 3b: q1 at 4 partitions, AQE on (default) and off")
    q1_parts = {}
    for label, conf, need in (
            ("aqe on", None, list(SEG_SUM_BUILDS)),
            ("aqe off", {"spark.sql.adaptive.enabled": False},
             list(SEG_SUM_BUILDS) + ["murmur3_long"])):
        s4 = srt.session(conf=conf)
        q4 = q1(s4.create_dataframe(data, num_partitions=4), F)
        q1_mm_calls: list = []
        q4_seg_calls: dict = {}
        with recording(K, "murmur3_long", q1_mm_calls), \
                recording_seg_sums(K, q4_seg_calls):
            t4, _, _ = drive(f"q1, 4 partitions, {label}", q4.collect, K,
                             torch, need)
        for name in SEG_SUM_BUILDS:
            err[name] = max(err[name], check_seg_sum_calls(
                K, torch, name, f"q1 4 partitions {label}",
                q4_seg_calls[name]))
        del q4_seg_calls
        if q1_mm_calls:
            err["murmur3_long"] = max(
                err["murmur3_long"],
                check_murmur3_calls(K, torch, f"q1 4 partitions {label}",
                                    q1_mm_calls))
        check_result(t4, want, f"q1 4 partitions {label}")
        ex = exchanges_of(s4.last_plan)
        log("  exchanges: " + "; ".join(
            f"{e.partitioning.simple_string()} coalesced={e.coalesced} "
            f"rows_partitioned={e.rows_partitioned}" for e in ex))
        q1_parts[label] = q4
    log("  q1 at 4 partitions matches the oracle (and so q1 in one "
        "partition) with AQE on and off")

    log(f"phase 3c: TPC-H Q18 inner aggregate at SF1 ({SF1_ORDERS} orders, "
        "4 partitions)")
    li, okeys, lines = make_lineitem(SF1_ORDERS)
    n_li = li["l_orderkey"].size
    want_keys, want_sums = q18_oracle(li, okeys, lines)
    q18 = q18_inner(sess.create_dataframe(li, num_partitions=4), F)
    mm_calls: list = []
    with recording(K, "murmur3_long", mm_calls):
        t18, q18_launches, _ = drive(
            f"Q18-inner, {n_li} lineitem rows", q18.collect, K, torch,
            ["murmur3_long"])
    err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
        K, torch, "Q18-inner", mm_calls))
    hash_ex = [e for e in exchanges_of(sess.last_plan)
               if type(e.partitioning).__name__ == "HashPartitioning"]
    for e in exchanges_of(sess.last_plan):
        log(f"  exchange {e.partitioning.simple_string()}: coalesced="
            f"{e.coalesced} rows_partitioned={e.rows_partitioned}")
    if len(hash_ex) != 1 or hash_ex[0].coalesced is not False:
        raise AssertionError("Q18-inner: the hash exchange coalesced")
    got_keys = np.ma.getdata(t18.column("l_orderkey"))
    got_sums = np.ma.getdata(t18.column("sum_qty"))
    if t18.num_rows != want_keys.size or \
            not np.array_equal(got_keys, want_keys) or \
            not np.array_equal(got_sums, want_sums) or \
            np.ma.getmaskarray(t18.column("sum_qty")).any():
        raise AssertionError(f"Q18-inner: {t18.num_rows} rows differ from "
                             f"the oracle's {want_keys.size}")
    log(f"  Q18-inner matches the numpy oracle exactly: {t18.num_rows} "
        f"orders, first {list(zip(got_keys[:3].tolist(), got_sums[:3]))}")

    log("phase 3d: repartition(8, l_orderkey) and hash(l_orderkey)")
    li_rows = dict(li, row=np.arange(n_li, dtype=np.int64))
    df_li = sess.create_dataframe(li_rows, num_partitions=4)
    rep = sess.physical_plan(df_li.repartition(8, "l_orderkey"))

    def run_partitions():
        return [list(rep.execute(pid)) for pid in range(8)]
    parts, _, _ = drive("repartition(8, l_orderkey)", run_partitions, K,
                        torch, ["murmur3_long"])
    seen = []
    for pid, batches in enumerate(parts):
        for b in batches:
            n = b.num_rows_int
            key = b.columns[0].data[:n]
            want_pid = torch.remainder(K.murmur3_long_plain(key, 42), 8)
            if not bool((want_pid == pid).all()):
                raise AssertionError(f"repartition: rows in partition {pid} "
                                     "that hash elsewhere")
            seen.append(b.columns[2].data[:n])
    rows = torch.sort(torch.cat(seen)).values
    if not torch.equal(rows, torch.arange(n_li, device=rows.device)):
        raise AssertionError("repartition: rows lost or repeated")
    log(f"  repartition: {n_li} rows, each once, each in partition "
        "pmod(murmur3(key, 42), 8); a key's partition is a function of the "
        "key, so no key is in two partitions; sizes "
        f"{[sum(b.num_rows_int for b in p) for p in parts]}")
    hashed = df_li.withColumn("h", F.hash("l_orderkey"))
    th, _, _ = drive("withColumn(h, hash(l_orderkey))", hashed.collect, K,
                     torch, ["murmur3_long"])
    want_h = K.murmur3_long_plain(
        torch.from_numpy(li["l_orderkey"]).cuda(), 42).cpu().numpy()
    if not np.array_equal(np.ma.getdata(th.column("h")), want_h):
        raise AssertionError("hash(l_orderkey) differs from the plain "
                             "version")
    log("  hash(l_orderkey) equals the plain version on every row")

    # -- phase 4: times ------------------------------------------------------
    log("phase 4: times")
    warm, times = warm_ms(query, torch)
    log(f"  warm q1, one partition: median {warm:.3f} ms of "
        f"{[round(t, 3) for t in times]} ms -> {ROWS / warm * 1e3:.0f} "
        "rows/s")
    for label, q4 in q1_parts.items():
        w4, t4s = warm_ms(q4, torch)
        log(f"  warm q1, 4 partitions, {label}: median {w4:.3f} ms of "
            f"{[round(t, 3) for t in t4s]} ms -> {ROWS / w4 * 1e3:.0f} "
            "rows/s")
    w18, t18s = warm_ms(q18, torch)
    log(f"  warm Q18-inner SF1: median {w18:.3f} ms of "
        f"{[round(t, 3) for t in t18s]} ms -> {n_li / w18 * 1e3:.0f} "
        "lineitem rows/s")
    log(f"  bounds use the H100 SXM data-sheet bandwidth, "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    seg = {name: seg_sum_times(K, torch, name, seg_calls[name])
           for name in SEG_SUM_BUILDS}
    for name, t in seg.items():
        log(f"  {name} per q1 run ({len(seg_calls[name])} launches): " +
            ", ".join(f"{k}={v:.5f}" for k, v in t.items()))
    log("  (seg_sum times are per q1 run: the sum over its launches, each "
        "after an L2 flush; library_ms is the better of index_add_ on "
        "[s, n] and on [n, s])")
    mm = murmur3_times(K, torch, mm_calls)
    log(f"  (murmur3_long times are per Q18-inner run: the sum over its "
        f"{len(mm_calls)} launches, {mm['bytes']} bytes)")
    log("  murmur3_long library_ms: null, no single PyTorch call computes "
        "Spark's murmur3")
    n_alone = 1 << 23
    rng = np.random.default_rng(SEED + 1)
    v = torch.from_numpy(rng.integers(np.iinfo(np.int64).min,
                                      np.iinfo(np.int64).max, n_alone,
                                      dtype=np.int64)).cuda()
    sd = torch.from_numpy(rng.integers(0, 1 << 32, n_alone, dtype=np.uint64)
                          .astype(np.uint32).view(np.int32)).cuda()
    for label, seed in (("per-row", sd), ("scalar", 42)):
        log(f"  murmur3_long alone, n=2^23, {label} seed: kernel "
            f"{cuda_ms(lambda: K.murmur3_long(v, seed)):.5f} ms, plain "
            f"{cuda_ms(lambda: K.murmur3_long_plain(v, seed)):.5f} ms, "
            f"bound {murmur3_bytes(v, seed) / HBM_BYTES_PER_S * 1e3:.5f} ms")
    f64_adds = profile_query("q1", query, torch)
    if f64_adds:
        raise AssertionError("q1's profile shows float64 index_add_ kernels: "
                             f"{[k[:80] for k, _, _ in f64_adds]}")
    profile_query("q1, 4 partitions, aqe off", q1_parts["aqe off"], torch)
    profile_query("Q18-inner", q18, torch)
    replaces = {
        "seg_sum_f32": "spark_rapids_tpu/ops/pallas_kernels.py:126",
        # no Pallas kernel: the XLA scatter seg_sum2 of the double sums
        "seg_sum_f64": "spark_rapids_tpu/ops/segmented.py:68"}
    kernels = [{
        "name": name, "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/seg_sum.cu",
        "replaces": replaces[name],
        "launches": q1_launches[name],
        "max_abs_err": err[name],
        "ms": seg[name]["ms"], "plain_ms": seg[name]["plain_ms"],
        "bound_ms": seg[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": seg[name]["library_ms"],
    } for name in SEG_SUM_BUILDS] + [{
        "name": "murmur3_long", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:64",
        "launches": q18_launches["murmur3_long"],
        "max_abs_err": err["murmur3_long"],
        "ms": mm["ms"], "plain_ms": mm["plain_ms"],
        "bound_ms": mm["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    log(card)
    # the run used one card, device 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
