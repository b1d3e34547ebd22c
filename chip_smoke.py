"""Smoke run of the PyTorch/CUDA port (spark_rapids_tpu_torch) on one NVIDIA
card: the quickest proof that the port starts, builds its kernels and answers
its main paths on the GPU.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1 and 2, and each kernel alone
                                      # at q1's shapes; no result line
    python3 chip_smoke.py --sql       # phases 1, 2 and 3i, and 3i's times;
                                      # no result line
    python3 chip_smoke.py --tpcds     # phases 1, 2 and 3j, and 3j's times;
                                      # no result line
    python3 chip_smoke.py --decimal   # phases 1, 2 and 3k, and 3k's times;
                                      # no result line
    python3 chip_smoke.py --tlc       # phases 1, 2 and 3l, and 3l's times;
                                      # no result line
    python3 chip_smoke.py --parquet   # phases 1, 2 and 3m, and 3m's times;
                                      # no result line
    python3 chip_smoke.py --api       # phases 1, 2 and 3o, and 3o's times;
                                      # no result line
    python3 chip_smoke.py --strings   # phases 1, 2 and 3p, and 3p's times;
                                      # no result line

Every phase header carries the seconds since the start ("phase 3k [t=512.3
s]: ..."), so the tail of a cut run names its phase, and a hang dumps every
thread's stack at 1,140 s.  Before the ``kernels`` line the script prints
``{"phase_seconds": {...}, "profile_s": ..., "total_s": ...,
"host_cpus": ..., "host_probe_s": [...]}``: each phase's seconds, the
seconds inside the profiled runs, the command's seconds, the cores the
process may use, and the host's speed: a fixed single-threaded workload's
seconds at the start and at the end (:func:`host_probe`).  The script's
time moves with the host's speed from run to run while the card's kernel
times do not.

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
   6,000,000, int64 edge values), and pcg64 (rand()'s draw: bit for bit
   numpy's PCG64 stream at a partition's 2^21 draws, at large offsets and at
   the edges of a thread's rows and a block's tile), md5 (byte for byte,
   and hashlib's, at rows of 0, 55, 56, 63, 64, 119 and 120 bytes, a row of
   the full width, aligned and unaligned widths, and o_comment's 1.5M rows),
   dtoa_shortest (digits, exponents and sides equal at +-0, the smallest
   subnormals, the largest double, 1e-3, 1e7 and 1e16 and their
   neighbours, 1e23, 2^53 +- 1, NaN, +-inf and the float edges, over 2^21
   random double and float bit patterns and a partition of money; the edges
   Java's text) and the DFA walks dfa_search and dfa_match_spans (equal over
   4,096 rows of 0 to 64 bytes, empty and full-width rows among them, for
   patterns anchored at either end, and for a 255-state, 200-class table in
   dynamic shared memory);
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
   e. the whole of TPC-H Q18 at SF1 (150,000 customers, 1,500,000 orders,
      the same lineitem, 4 partitions each, default configuration): the big
      orders' aggregate, customer-orders and -lineitem inner joins, the
      left-semi join with the big orders, the aggregate by c_name,
      customer and order, order by price descending and date, limit 100;
      every column exact against a numpy oracle (isin, bincount, lexsort),
      c_name included; each join's strategy printed with its build side's
      bytes and bloom filter, and the run fails unless they are
      Q18_STRATEGIES; murmur3_long and both seg_sum builds must launch, and
      each of their calls is replayed against the plain version (bit for
      bit; the sums are of integer-valued doubles).  Under the defaults
      the final aggregate's exchange coalesces (57 partial rows), so Q18
      runs again with coalescePartitions.minRows 0, exact, where that
      exchange must hash c_name's bytes (murmur3_bytes) and then chain
      per-row seeds through murmur3_long, each call held bit for bit.  Q18
      without c_name (the query before the port had strings) runs too,
      exact.  Then Q18 again at a 32 MiB broadcast
      threshold, where the semi join broadcasts (exact again), and
      lineitem joined with the orders above the median price once for each
      of the six join types: row count and exact key sums against numpy;
   f. windows.  Path 1: bench.py's window shape (bench.py:703-741, seed 8)
      at 8,000,000 rows in 4 partitions, the running sum of v per k by t,
      then its global sum: the window's hash exchange must hash every row,
      murmur3_long and both seg_sum builds (the global sum's partials) must
      launch and every call of theirs is replayed against the plain
      version; the total within RTOL_F64 of numpy, and every running sum
      (collected without the sum) within RTOL_F64 plus RTOL_F64 of the
      largest prefix a frame sum subtracts; once at the default chunk
      target (one key-complete chunk per reduce partition) and once at
      2^18 rows (several).  Path 2: rank() <= 1 per order over the SF1
      lineitem, exact against numpy (every line with its order's largest
      quantity, ties kept), with WindowGroupLimitExec below the exchange;
      murmur3_long must launch, each call replayed.  Then a matrix of every
      ported window function over ROWS and RANGE frames, 1,000,000 rows
      with nulls, run on cuda and on the cpu: every column equal, a sum of
      random doubles within RTOL_F64 plus RTOL_F64 of its largest prefix;
      the matrix holds ROADMAP C1's frames (RANGE offsets over a double key
      with NaN and +-inf and an int64 key at both ends of its range), and
      C1's three cases give Spark's frames on cuda;
   g. strings.  TPC-H q1 by its string keys (the scale rig's _tpch_q1 over
      its lineitem generator, SF1: 6,000,000 rows, seed 23) in one
      partition and at 4 with AQE on and off (AQE off: the hash exchange
      hashes both string keys with murmur3_bytes, and the range exchange
      sorts by them); both seg_sum builds must launch in each, every call
      replayed against the plain version; keys and counts exact, doubles
      within RTOL_F64 of a numpy oracle.  Then a matrix of string queries
      over 1,000,000 rows in 4 partitions (a sort, a group-by with
      min/max, a join, lead/lag and windowed min/max), run on cuda and on
      the cpu: every column equal;
   h. the scale rig's ten DataFrame queries (testing/scaletest.py:590-600,
      q1_filter_agg ... tpch_q14_promo_case) as the rig writes them, with
      its scan partitions (4 and 2) and the default configuration, over
      copies of its generators: build_tables at 3,000,000 fact rows (seed
      17; 30,000 dimension keys, 20% of the rows on 1% of them, strings of
      up to 12 characters with the special "é中ñ") and build_tpch_tables
      at SF1 (seed 23: 6,000,000 lineitem rows, 1,500,000 orders, 750,000
      parts); each query checked against a numpy copy of its pandas oracle,
      every hand-kernel call it made replayed against the plain version,
      and seg_sum_f32, seg_sum_f64 and murmur3_long each launched by at
      least one of them.  Then a matrix of every expression of the scalar
      slice (predicates, IN, CASE WHEN, coalesce, nanvl, casts, string and
      date functions, expressions over aggregates, first/last, count())
      over 1,000,000 rows with NaN, +-inf, -0.0, int limits, multi-byte
      strings, dates from 0001-01-01 to 9999-12-31 and nulls, run on cuda
      and on the cpu: every column equal;
   i. the scale rig's 21 TPC-H SQL queries (testing/tpch_queries.py's 16
      QUERY_SET texts and testing/scaletest.py:604-608's five SQL entries)
      exactly as the JAX package writes them, through session.sql(...)
      .collect() over copies of build_tables at SF 0.5 (seed 23: 3,000,000
      lineitem rows, 750,000 orders, 375,000 customers and parts, 5,000
      suppliers, 1,500,000 partsupp rows, 25 nations, 5 regions; tables of
      their own, which phases 3k and 3m share), the 8 tables as views at 4
      partitions under the default configuration;
      each query checked against a numpy copy of its pandas oracle, every
      hand-kernel call it made replayed against the plain version, its
      joins printed in plan order (exec, type, equi-keys, residual
      condition, and the build side's rows of a nested-loop join), and
      seg_sum_f32, seg_sum_f64 and murmur3_long each launched by at least
      one of them; q15 (its revenue view computed twice, compared for
      equality) runs three times and must give the same rows each time;
   j. the scale rig's 44 TPC-DS SQL queries (testing/tpcds_queries.py's
      QUERY_SET: star joins, set operations, ROLLUP, mixed DISTINCT,
      stddev_samp, CTEs and subqueries) exactly as the JAX package writes
      them, through session.sql(...).collect() over a copy of its
      build_tables near SF1 (seed 31: 2,880,000 store_sales rows,
      1,440,000 catalog_sales and inventory rows, 960,000 web_sales rows,
      576,000 store_returns rows, 57,600 items, 144,000 customers, 72,000
      addresses), store_sales a view at 4 partitions and the other 18
      tables at 2, default configuration; then the rig's five TPC-DS
      DataFrame shapes (testing/scaletest.py:418-589) over the same
      tables; each checked against a numpy copy of its pandas oracle
      (rows as a multiset, floats within rtol and atol 1e-6; the shapes
      in order, as the rig checks them), every hand-kernel call replayed
      against the plain version, its joins printed in plan order, and
      seg_sum_f32, seg_sum_f64 and murmur3_long each launched by at least
      one of them; q40 must plan hash joins and no nested-loop join over
      more than one build row; q94 and q95 (mixed DISTINCT) run twice and
      must give the same bits;
   k. decimals: phase 3i's 21 texts over the same SF 0.5 tables with every
      TPC-H money column (l_quantity, l_extendedprice, l_discount, l_tax,
      o_totalprice, c_acctbal, s_acctbal, ps_supplycost, p_retailprice)
      a decimal(12,2) of unscaled value round(x * 100), views at 4
      partitions, defaults; each held exactly against a numpy oracle over
      the unscaled integers (Python ints past 2^63; averages and q8's
      decimal(38,38) share HALF_UP as Spark types them; q17's double
      within RTOL_F64), every hand-kernel call replayed against the plain
      version, seg_sum_f32 launched in q1 and murmur3_long in q18.  Then a
      matrix of 1,000,000 rows at 4 partitions with decimal(12,2),
      decimal(18,4) and decimal(38,10) columns at +-(10^p - 1) and
      around +-2^63 and +-2^64, bytes, shorts and nulls: every operator
      of arithmetic.py, the decimal casts, floor/ceil/round/bround, hash
      and xxhash64, sum/avg/min/max, and a decimal key through group,
      sort, a shuffled join and the hash exchange, run on cuda and on the
      cpu: every column equal;
   l. text to typed: a month of NYC yellow-taxi trips (8,000,000 rows, seed
      2019) in the 18 columns of the TLC's 2019 yellow CSV files, every
      column a string as spark.read.csv gives it without a schema, made
      with numpy as byte matrices (make_tlc_trips states the
      distributions); the typed view ``trips`` over ``trips_raw`` at 4
      partitions, defaults (int, timestamp, double and decimal(10,2)
      casts, to_timestamp, upper(trim(...))), and seven queries over it
      (TLC_QUERIES: by hour, by hour as a timestamp made from text, the
      duplicate trips by two timestamp keys and a zone through the hash
      exchange, by day text and payment with unix_timestamp durations,
      the top routes by concat_ws of lpad'd ids, a zone's 7-day decimal
      window sum and average, and the export of 8M text lines), each
      exact on its first call against a numpy oracle over the generator's
      integers (doubles within RTOL_F64), every hand-kernel call replayed
      against the plain version, seg_sum_f32 and seg_sum_f64 launched in
      tlc_hourly and murmur3_long in tlc_duplicates.  Then a matrix of
      every new function and cast (TLC_MATRIX) over 1,000,000 rows with
      nulls, empty and multi-byte strings, leap days, micros before 1970
      and near year 9999 and 38-digit decimals, on cuda and on the cpu:
      every column equal;
   m. Parquet, without pyarrow: phase 3k's SF 0.5 decimal tables written by
      the port (create_dataframe(...).write.parquet, 4 snappy part files
      a table, lineitem orderBy l_shipdate first), read back with
      session.read.parquet as views under the default configuration, and
      phase 3k's 21 texts over them, each exact on its first call by its
      decimal oracle, every hand-kernel call replayed against its plain
      version (seg_sum_f32 must launch in q1, murmur3_long in q18), every
      file of every scan decoded on the card with every column unless
      pruning left it no row group, and q6 skipping row groups by
      l_shipdate; the scale rig's Parquet leg (scan_engagement_report's
      filter-and-aggregate over phase 3h's 3M-row fact table, written by
      the port): exact by the rig's check, every file engaged; a
      1,000,000-row matrix of every type the port has (nulls, NaN, +-inf,
      -0.0, int limits, decimal(12,2)/(18,4)/(38,10) at +-(10^p - 1),
      dates 0001-9999, micros before 1970, empty, multi-byte and 200-byte
      strings, binary, and a string of a value a row whose dictionary
      falls back to PLAIN) written with no codec, snappy and gzip and read
      on cuda and on the cpu, every column's bits equal to the input's;
      partitionBy, the four save modes, cache() and parquet.`path` from
      SQL; and pyarrow never imported;
   o. the DataFrame and session API leftovers through the normal entry
      points over the SF1 lineitem (phase 3g's tables, 4 partitions) and
      the rig's 3M-row fact table, each against numpy: pivot of
      sum(l_quantity) by the two flags (exact), describe and summary of
      the money columns (counts, min, max exact, mean and stddev within
      RTOL_F64, the summary's percentiles by the t-digest within its rank
      error), percentile_approx(l_extendedprice, [0.25, 0.5, 0.75]) by the
      two flags under the t-digest (rank error), approxQuantile under the
      exact strategy (numpy's ordinals), crosstab (exact), corr and cov
      (RTOL_F64), na.drop/fill/replace over the fact table's nullable
      columns (exact counts and sums), dropDuplicates by its key (a hash
      exchange), unpivot of the money columns (sums within RTOL_F64),
      randomSplit([0.8, 0.2], 7) (every row in the split numpy's stream
      puts it in: disjoint and covering), sample(0.1, 3) (within 5 sigma
      of the binomial, and the host stream's rows), rand(11),
      spark_partition_id and monotonically_increasing_id (bit for bit
      numpy's stream on every partition, Spark's id layout), and
      input_file_name() over phase 3m's files of the fact table (each
      file's footer rows); seg_sum_f32, murmur3_long and pcg64 must launch
      in the phase;
   p. this slice's functions over phase 3g's SF1 tables (4 partitions),
      each driven with its launches counted and exact against a Python
      oracle: o_comment RLIKE 'special.*requests' (a count of 1.5M rows),
      regexp_replace(l_comment, '[aeiou]+', '#') by l_returnflag (6M rows;
      l_comment made from 256 comments of TPC-H words, seed 161),
      regexp_extract(c_phone, '^[0-9]+', 0) by country code, split(p_name,
      ' ') over SF1's 200,000 parts, md5(o_comment) by digest (hashlib),
      CAST(l_extendedprice AS STRING) by l_returnflag (the lengths, '.5'
      endings and digits of the cents' text), 50,000 rows of the rig's fact
      table as text row by row, its doubles and the same values as floats
      (Java's Double.toString and Float.toString), q1's sums through
      format_number
      (DecimalFormat's rule over the sums themselves), conv(o_orderkey, 10,
      16) and translate(p_name, 'ae', 'äé'); md5, dtoa_shortest,
      dfa_search and dfa_match_spans must launch in the phase, and after
      each item every call it made of them is replayed through the kernel
      and its plain version, every output equal; then every
      function of the slice over 262,144 rows on cuda and on the cpu (the
      cpu side runs beside the items): every column equal;
4. times: warm q1 at one and at four partitions, warm Q18-inner, cold and
   warm Q18 and both window paths (median of 3 each), a profile of one warm
   q1 (which must show no float64 index_add_ kernel), one warm Q18-inner,
   one warm Q18 and one warm run of each window path (none may show a
   running min or max scan, cummin/cummax); warm Q18 without c_name, warm
   q1 by strings (1 and 4 partitions, AQE on and off) and profiles of it;
   each profile of q1, Q18 at minRows 0, q1 by strings with AQE off and
   the window paths reads host ops too and gives murmur3_bytes' calls,
   kernel launches and device time, the others (q1 at 4 partitions with
   AQE off, Q18-inner, Q18, Q18 without c_name, q1 by strings in one
   partition, the rig's) device kernels only; the calls of Q18 and of q1 by strings with AQE off are
   replayed alone against their bound; and for each kernel on the
   inputs its main paths gave it (murmur3_long: Q18's and the window
   paths'; each launch after an L2 flush): the kernel, its plain version,
   one library call computing the same function where there is one (for
   seg_sum the better of index_add_ on the [s, n] and on the [n, s]
   layout), and the bound that the card's bandwidth sets; each rig query
   cold and warm (median of 3 after a warm-up), and those ``PROFILED``
   names profiled (busy share, top kernels, hand-kernel launches), printed
   as the ``rig`` JSON line; each SQL query cold and warm (every run
   parses and plans anew: its scalar subqueries are collected while
   planning), those ``PROFILED`` names profiled, printed as the ``sql``
   JSON line with each query's joins, and each TPC-DS query and shape so,
   as the ``tpcds`` JSON line, each decimal query so beside its float64
   form's warm ms of the same call, as the ``decimal`` JSON line, each TLC
   query so, as the ``tlc`` JSON line, and each Parquet query cold, warm
   (the files in the page cache) with its scan's host and upload ms, copy
   and decode spans on the stream (CUDA events; a decode span includes the
   gaps while Python enqueues it) and row groups read and skipped, beside
   the in-memory decimal tables' warm ms, as the ``parquet`` JSON line
   (every warm time one run after the cold one, since phase 3o);
   seg_sum2's fixed-order double sum at a
   merge's shape against the index_add_ it replaced and against
   index_put_(accumulate=True), with its bits the same on reruns; and
   murmur3_long at Q18's n = 2^21 timed over 256 back-to-back launches
   cycling through 128 MB of inputs (events around the run, a sleep kernel
   ahead of it so the wrapper's host time does not count); phase 3o's items
   warm and profiled, as the ``api`` JSON line, and pcg64 at rand(11)'s launches against
   its plain version and its bound (8 bytes written a draw), each launch
   after an L2 flush, and over 256 back-to-back launches of 2^21 draws with
   the last 8 outputs kept alive (128 MB), as murmur3_long is; phase 3p's
   items warm, as the ``strings`` JSON line, and md5, dtoa_shortest,
   dfa_search and dfa_match_spans on the calls of one item each against
   their plain versions and their bounds (bytes at 3.35 TB/s or 32-bit
   integer operations at 132 x 64 x 1.98 GHz, the larger, for the item's
   live rows: padded rows are not counted).  Every L2
   flush reads 256 MB (``cuda_ms``), so the timed launch pays for no dirty
   line of the flush's.

The last two lines before the final one are the ``kernels`` JSON line (with
each kernel's launches on every main path) and the card as ``nvidia-smi``
names it; the final line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import faulthandler
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
#: TPC-H scale factor 1: customers in the CUSTOMER table (spec 4.2.5)
SF1_CUSTOMERS = 150_000
#: Q18's join strategies (customer-orders, -lineitem, the semi join with
#: the big orders) under the default configuration.  The JAX package's rule
#: gives these at SF1: AQE counts each materialized build side's device
#: bytes against the 10 MiB threshold, and the big orders are 8
#: final-aggregate partitions of capacity 262,144 (18.9 MB), not 57 rows
Q18_STRATEGIES = ["shuffle", "shuffle", "shuffle"]
#: a broadcast threshold between the big orders' 18.9 MB and the orders'
#: 67 MB, under which the semi join broadcasts its build side
Q18_BROADCAST_THRESHOLD = 32 << 20
Q18_BROADCAST_STRATEGIES = ["shuffle", "shuffle", "broadcast"]
#: the join types of phase 3e's lineitem-orders matrix
JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti")
#: the scale rig's TPC-H data seed (testing/scaletest.py build_tpch_tables)
TPCH_SEED = 23
#: TPC-H scale factor 1: rows of LINEITEM, about 6,000,000 (spec 4.2.5)
SF1_LINEITEM = 6_000_000
#: phases 3i, 3k and 3m's tables: TPC-H SF 0.5, their own (SF1's cost the
#: script its 720 s); 3k runs 3i's texts over the same tables and 3m writes
#: 3k's, and each compares its warm times with the one before
SQL_LINEITEM = SF1_LINEITEM // 2
#: the window paths' data seed (bench.py _measure_window's)
WINDOW_SEED = 8
#: rows of each matrix run on cuda and on the cpu (phases 3f-3h and 3k-3m):
#: they hold the two devices to the same answers, not scale, and their cpu
#: sides run in the background (1,000,000 until the script's time was cut
#: to fit phase 3o)
MATRIX_ROWS = 1 << 18
#: the smaller key-complete chunk target phase 3f runs path 1 at again:
#: about 8 chunks in each of its 4 reduce partitions
WINDOW_SMALL_TARGET = 1 << 18
#: rows of phase 3f's window matrix, run on cuda and on the cpu
WINDOW_MATRIX_ROWS = MATRIX_ROWS
#: rows of phase 3g's string matrix, run on cuda and on the cpu
STRING_MATRIX_ROWS = MATRIX_ROWS
#: the queries each phase 4 part profiles, by part: a fixed subset (each
#: profile is one more run and its trace's processing, 279.5 s of a 975.8 s
#: run when every query was profiled); every item of phase 3o is profiled
PROFILED = {
    "rig": ("q2_join_agg", "tpch_q1", "tpch_q14_promo_case"),
    "sql": ("tpch_q1_sql", "q18", "q21"),
    "tpcds": ("q11_yoy_ratio", "q42_category_rev_sql", "q53_manufact_window",
              "q95_cte_in_chains", "tpcds_q3_star_join"),
    "decimal": ("tpch_q1_sql", "q8", "q18"),
    "tlc": ("tlc_hourly", "tlc_export"),
    "parquet": ("tpch_q1_sql", "tpch_q6_sql", "q21"),
}
#: the kernels of the port, by source file under spark_rapids_tpu_torch/csrc
KERNEL_SOURCES = ("seg_sum", "murmur3", "pcg64", "md5", "dtoa", "regex_dfa")
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


#: when the script started, for the running clock of the phase headers
T_START = time.perf_counter()
#: (phase, second it began at) in the order the phases began; a phase lasts
#: until the next one begins
PHASE_MARKS: list = []
#: seconds spent inside ``profile_query`` (the profiled runs and reading
#: their traces), a part of phase 4's
PROFILE_SECONDS = [0.0]
#: :func:`host_probe`'s seconds at the start
HOST_PROBE_AT_START: list = []


def host_probe() -> float:
    """Seconds of a fixed single-threaded host workload: a Python loop of
    10^6 multiply-adds and a numpy sort of 2^21 doubles."""
    x = np.random.default_rng(0).random(1 << 21)
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i * i
    np.sort(x)
    return round(time.perf_counter() - t0, 4)




def phase(key: str, text: str) -> None:
    """Begin phase ``key``: its header carries the seconds since the start,
    so the tail of a cut run names the phase it was in."""
    t = time.perf_counter() - T_START
    PHASE_MARKS.append((key, t))
    log(f"phase {key} [t={t:.1f} s]: {text}")


def phase_seconds() -> dict:
    """The ``phase_seconds`` JSON object: each phase's seconds (a phase
    begun twice sums), the total and the host's usable cores."""
    now = time.perf_counter() - T_START
    out: dict = {}
    for (key, t0), (_, t1) in zip(PHASE_MARKS, PHASE_MARKS[1:] + [("", now)]):
        out[key] = round(out.get(key, 0.0) + t1 - t0, 3)
    return {"phase_seconds": out, "profile_s": round(PROFILE_SECONDS[0], 3),
            "total_s": round(now, 3),
            "host_cpus": len(os.sched_getaffinity(0)),
            "host_probe_s": HOST_PROBE_AT_START + [host_probe()]}


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
    With ``flush_l2`` each launch is timed alone after a sum reads 256 MB,
    which evicts the 50 MB L2 (and keeps the card busy while the host
    enqueues ``fn``), so inputs that fit in L2 come from device memory as
    the main path finds them.  The read leaves only clean lines in L2, so
    the launch pays for no write-back of the flush's (a flush by writing
    left up to 50 MB dirty, and the launch paid for writing them back)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if flush_l2:
        scrap = torch.zeros(1 << 26, dtype=torch.int32, device="cuda")
        ends = [(torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ends:
            scrap.sum()
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

    def rel_err(ref):
        diff = (a.double() - ref).abs()
        return float(torch.where(ref != 0, diff / ref.abs(), diff).max())
    rel = rel_err(ref)
    if rel > rtol and vals.dtype == torch.float64:
        # the plain version adds with atomics, in arrival order: hold the
        # kernel to the same limit against a sum in extended precision
        plain_rel = rel
        rel = rel_err(extended_seg_sum(torch, vals, rank, out_size))
        log(f"  {label}: kernel vs plain {plain_rel:.3e} relative; kernel "
            f"vs an extended-precision sum {rel:.3e} (limit {rtol})")
    if rel > rtol:
        raise AssertionError(f"{label}: max relative error {rel} > {rtol}")
    return err, rel


def extended_seg_sum(torch, vals, rank, out_size: int):
    """[s, n] values summed by rank in numpy's long double (64-bit
    mantissa on x86-64: n * 2^-64 relative error at most, 5e-14 at 2^20
    terms), rounded to float64 on the card; ranks outside the table add
    nothing."""
    if np.finfo(np.longdouble).eps > 1e-18:
        raise AssertionError("no extended precision long double here")
    v = vals.cpu().numpy().astype(np.longdouble)
    r = rank.cpu().numpy().astype(np.int64)
    live = (r >= 0) & (r < out_size)
    order = np.argsort(r[live], kind="stable")
    rs = r[live][order]
    out = np.zeros((v.shape[0], out_size), dtype=np.longdouble)
    if rs.size:
        starts = np.flatnonzero(np.r_[True, rs[1:] != rs[:-1]])
        sums = np.add.reduceat(v[:, live][:, order], starts, axis=1)
        out[:, rs[starts]] = sums
    return torch.from_numpy(out.astype(np.float64)).to(vals.device)


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
def recording(K, name: str, calls: list,
              on_card=lambda args: args[0].is_cuda):
    """Record the arguments of every call of ``K.<name>`` on the card in
    ``calls`` (a CPU session's calls, which take the plain version, are
    not recorded: phase 3l runs one in a thread beside the main path).
    ``on_card(args)`` tells a call on the card: by its first tensor, or
    for ``pcg64_uniform`` by its device argument."""
    launch = getattr(K, name)

    def record(*args):
        if on_card(args):
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


def drive(label: str, fn, K, torch, must_launch=(), book=None):
    """Run one main path with every launch count set to 0 just before it
    and read just after; fail if a kernel of ``must_launch`` did not
    launch.  ``book`` (a dict) keeps the counts under ``label``.  Returns
    (result, launches, seconds)."""
    K.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if book is not None:
        book[label] = launches
    log(f"  {label}: {secs:.4f} s (cold) [t={time.perf_counter() - T_START:.1f}"
        f" s]; launches {launches}")
    for name in must_launch:
        if launches[name] < 1:
            raise AssertionError(f"{label} did not launch the {name} kernel")
    return out, launches, secs


def walk(phys):
    """Every exec of a plan, parents first."""
    yield phys
    for c in phys.children:
        yield from walk(c)


def exchanges_of(phys):
    from spark_rapids_tpu_torch.sql.physical.exchange import \
        ShuffleExchangeExec
    found = [phys] if isinstance(phys, ShuffleExchangeExec) else []
    for c in phys.children:
        found.extend(exchanges_of(c))
    return found


#: warm runs of each decimal and TLC query (phase 4): the median of 3 right
#: after the cold run (of 5 after a warm-up until phase 3m needed the time;
#: of 3 until phase 3o did: the script cut from 975.8 s to its 720 s target)
SQL_WARM_RUNS = 1
#: warm runs of each float64 TPC-H SQL and TPC-DS query (phases 3i, 3j): one
#: run right after the cold run, beside its light profile (5 after a
#: warm-up until phase 3m needed the time)
WARM_RUNS_3I_3J = 1


#: warm runs of q1, Q18, the window paths and the rig's queries (phase 4):
#: the median of 3 (of 5 until the script passed its 720 s again)
WARM_RUNS = 3


def warm_ms(query, torch, runs: int = WARM_RUNS):
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        query.collect()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


#: the matrices' cpu sides, run one after another in one thread beside the
#: card's phases (torch's CPU ops release the interpreter lock) and held
#: against their cuda sides by ``finish_cpu_sides`` at the end of phase 3:
#: (label, future, check)
CPU_SIDES: list = []
_CPU_POOL: list = []


def cpu_side(label: str, compute, check) -> None:
    """Start a matrix's cpu side (``compute``, or a future already started)
    in the background; ``check(result)`` holds it against the cuda side at
    ``finish_cpu_sides``."""
    if not hasattr(compute, "result"):
        if not _CPU_POOL:
            _CPU_POOL.append(ThreadPoolExecutor(1))
        compute = _CPU_POOL[0].submit(compute)
    CPU_SIDES.append((label, compute, check))


def check_later(label: str, check, got, tables) -> None:
    """Hold a query's first result against its numpy oracle in the
    background (``cpu_side``): the oracles are host work that need not hold
    up the card's next query."""
    cpu_side(label, lambda: check(got, tables), lambda _: None)


def finish_cpu_sides() -> None:
    """Wait for every cpu side started with ``cpu_side`` (the matrices'
    cpu sides and the queries' oracle checks) and run its check."""
    t0 = time.perf_counter()
    for label, future, check in CPU_SIDES:
        try:
            check(future.result())
        except AssertionError as e:
            raise AssertionError(f"{label}: {e}") from e
    log(f"  {len(CPU_SIDES)} background checks passed (the matrices' cpu "
        "sides against their cuda sides, and every query's first result "
        "against its oracle); waited "
        f"{time.perf_counter() - t0:.3f} s for the last of them")
    CPU_SIDES.clear()
    for pool in _CPU_POOL:
        pool.shutdown()
    _CPU_POOL.clear()


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


def make_orders(okeys, n_cust: int):
    """Q18's customer and orders columns, from seed 43 (lineitem keeps seed
    42's stream): o_custkey uniform over the customer keys not divisible by
    3, o_orderdate uniform over [1992-01-01, 1998-12-31 - 151 days] as a
    date, o_totalprice a double rounded to cents (spec 4.2.3; drawn, not
    derived from lineitem prices, which are not generated); c_name
    "Customer#" and c_custkey zero-padded to 9 digits (18 bytes)."""
    n = okeys.size
    rng = np.random.default_rng(SEED + 1)
    j = rng.integers(0, n_cust - n_cust // 3, n)
    start = np.datetime64("1992-01-01")
    span = (np.datetime64("1998-12-31") - 151 - start).astype(int)
    date = start + rng.integers(0, span + 1, n)
    price = np.round(rng.uniform(1000.0, 500_000.0, n), 2)
    custkeys = np.arange(1, n_cust + 1, dtype=np.int64)
    cu = {"c_custkey": custkeys, "c_name": c_names(custkeys)}
    od = {"o_orderkey": okeys, "o_custkey": 3 * (j // 2) + j % 2 + 1,
          "o_orderdate": date, "o_totalprice": price}
    return cu, od


def c_names(custkeys):
    """TPC-H c_name (spec 4.2.3): "Customer#" and the key zero-padded to 9
    digits."""
    digits = np.zeros((custkeys.size, 9), dtype=np.uint32)
    k = custkeys.copy()
    for i in range(8, -1, -1):
        digits[:, i] = ord("0") + k % 10
        k //= 10
    prefix = np.array([ord(c) for c in "Customer#"], dtype=np.uint32)
    cp = np.concatenate([np.broadcast_to(prefix, (custkeys.size, 9)),
                         digits], axis=1)
    return np.ascontiguousarray(cp).view("<U18").reshape(custkeys.size)


def q18_full(cu, od, li, F, names=True):
    """TPC-H Q18: the big orders' inner aggregate, two inner joins, a
    left-semi join with the big orders, the aggregate by customer (c_name
    and c_custkey; without ``names``, c_custkey alone, as the port ran Q18
    before it had strings) and order, order by price descending and date,
    limit 100."""
    big = (li.groupBy("l_orderkey").agg(F.sum("l_quantity").alias("sum_qty"))
           .filter(F.col("sum_qty") > 300)
           .select(F.col("l_orderkey").alias("big_orderkey")))
    co = cu.join(od, cu["c_custkey"] == od["o_custkey"])
    col = co.join(li, co["o_orderkey"] == li["l_orderkey"])
    return (col.join(big, col["o_orderkey"] == big["big_orderkey"],
                     "left_semi")
            .groupBy(*(["c_name"] if names else []), "c_custkey",
                     "o_orderkey", "o_orderdate", "o_totalprice")
            .agg(F.sum("l_quantity").alias("sum_qty"))
            .orderBy(F.col("o_totalprice").desc(), F.col("o_orderdate"))
            .limit(100))


def q18_full_oracle(cu, od, li, sums, names=True):
    """Q18 in numpy: the big orders by bincount sums, their customers by
    isin, the order by lexsort; c_name from the customer's key."""
    keep = (sums > 300) & np.isin(od["o_custkey"], cu["c_custkey"])
    idx = np.nonzero(keep)[0]
    idx = idx[np.lexsort((od["o_orderdate"][idx],
                          -od["o_totalprice"][idx]))][:100]
    name = {"c_name": c_names(od["o_custkey"][idx])} if names else {}
    return {**name, "c_custkey": od["o_custkey"][idx],
            "o_orderkey": od["o_orderkey"][idx],
            "o_orderdate": od["o_orderdate"][idx],
            "o_totalprice": od["o_totalprice"][idx], "sum_qty": sums[idx]}


def check_exact(table, want, label: str) -> None:
    """Every column equal to the oracle's, bit for bit, with no null."""
    n = len(next(iter(want.values())))
    if table.num_rows != n or table.column_names != list(want):
        raise AssertionError(f"{label}: {table.num_rows} rows of "
                             f"{table.column_names}, want {n} of "
                             f"{list(want)}")
    for name, w in want.items():
        col = table.column(name)
        if np.ma.getmaskarray(col).any() or \
                not np.array_equal(np.ma.getdata(col), w):
            raise AssertionError(f"{label}: column {name} differs from "
                                 "the oracle")


def adaptive_joins(plan):
    """The adaptive joins of a plan that has run, innermost first."""
    from spark_rapids_tpu_torch.sql.physical.join import AdaptiveJoinExec
    found = []
    for c in plan.children:
        found.extend(adaptive_joins(c))
    if isinstance(plan, AdaptiveJoinExec):
        found.append(plan)
    return found


def report_joins(plan, label: str, want) -> list:
    """Print each adaptive join's choice, its build side's bytes and its
    bloom filter; fail where the strategies are not ``want``."""
    from spark_rapids_tpu_torch.sql.physical.join import join_strategies
    got = join_strategies(plan)
    for j in adaptive_joins(plan):
        bloom = getattr(j._chosen, "bloom", None)
        log(f"  {label}: {j.simple_string()}: build side "
            f"{j.build_bytes} device bytes; bloom (m, k) {bloom}")
    if got != want:
        raise AssertionError(f"{label}: join strategies {got}, want {want}")
    return got


def join_matrix_oracle(li, od_keep_keys, how: str):
    """(rows, sum of the valid l_orderkey, sum of the valid o_orderkey) of
    lineitem joined with the kept orders, from numpy."""
    lk = li["l_orderkey"]
    m = np.isin(lk, od_keep_keys)
    n_unmatched_orders = od_keep_keys.size - np.unique(lk[m]).size
    if how in ("left_semi", "left_anti"):
        sel = m if how == "left_semi" else ~m
        return int(sel.sum()), int(lk[sel].sum()), 0
    rows = int(m.sum())
    l_sum = int(lk[m].sum())
    o_sum = l_sum
    if how in ("left", "full"):
        rows += int((~m).sum())
        l_sum += int(lk[~m].sum())
    if how in ("right", "full"):
        rows += n_unmatched_orders
        o_sum += int(np.setdiff1d(od_keep_keys, lk[m]).sum())
    return rows, l_sum, o_sum


# --------------------------------------------------------------------------
# phase 3f: the window paths
# --------------------------------------------------------------------------

def make_window_data(rows: int):
    """bench.py's window shape (bench.py:703-741): k in [0, max(rows //
    1000, 8)), t a permutation of the rows, v random doubles, seed 8."""
    rng = np.random.default_rng(WINDOW_SEED)
    return {"k": rng.integers(0, max(rows // 1000, 8), rows),
            "t": rng.permutation(rows), "v": rng.random(rows)}


def running_sum(df, F, Window):
    """Path 1 without its aggregate: the running sum of v per k by t."""
    w = Window.partitionBy("k").orderBy("t")
    return df.withColumn("rs", F.sum(F.col("v")).over(w))


def window_total(df, F, Window):
    """Path 1, bench.py's query: the global sum of the running sums."""
    return running_sum(df, F, Window).agg(
        F.sum(F.col("rs")).alias("total"))


def running_sum_oracle(data):
    """rs per input row in numpy: rows sorted by (k, t), a cumsum inside
    each key (so no cancellation against other keys' rows)."""
    k, t, v = data["k"], data["t"], data["v"]
    order = np.lexsort((t, k))
    ks, vs = k[order], v[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    ends = np.r_[starts[1:], ks.size]
    rs_sorted = np.empty_like(vs)
    for a, b in zip(starts, ends):
        np.cumsum(vs[a:b], out=rs_sorted[a:b])
    rs = np.empty_like(rs_sorted)
    rs[order] = rs_sorted
    return rs


def prefix_scale(K, torch, data, num_partitions: int) -> float:
    """The largest sum of |v| over the rows of one reduce partition of the
    window's exchange (pmod(murmur3(k, 42), n), as the plain version gives
    it): a bound on every prefix the port's frame sums subtract."""
    pid = torch.remainder(K.murmur3_long_plain(
        torch.from_numpy(data["k"]).cuda(), 42), num_partitions)
    return float(np.bincount(pid.cpu().numpy(), weights=np.abs(data["v"]),
                             minlength=num_partitions).max())


def check_running_sums(table, data, rs_want, scale: float, label: str):
    """Every rs against the oracle: within rtol 1e-9 of the value plus
    1e-9 of ``scale``.  A frame sum is the difference of two entries of a
    prefix sum over the batch (the JAX package's arithmetic), so its error
    scales with the prefix, not with the (possibly tiny) difference."""
    t = np.ma.getdata(table.column("t"))
    rs = table.column("rs")
    if table.num_rows != rs_want.size or np.ma.getmaskarray(rs).any() or \
            not np.array_equal(np.sort(t), np.arange(rs_want.size)):
        raise AssertionError(f"{label}: rows lost, repeated or null")
    # t is a permutation: rows match by it
    got = np.empty_like(rs_want)
    got[t] = np.ma.getdata(rs)
    want = np.empty_like(rs_want)
    want[data["t"]] = rs_want
    np.testing.assert_allclose(got, want, rtol=RTOL_F64,
                               atol=RTOL_F64 * scale, err_msg=label)
    err = np.abs(got - want)
    big = want >= 1.0
    log(f"  {label}: {want.size} running sums within rtol {RTOL_F64} + "
        f"atol {RTOL_F64 * scale:.3e} ({RTOL_F64} x the largest partition's "
        f"sum of |v|, {scale:.6e}); max abs err {err.max():.3e}, max rel "
        f"err where rs >= 1: {(err[big] / want[big]).max():.3e}")


def rank_top_line(df, F, Window):
    """Path 2: the lines of each order with its largest quantity."""
    w = Window.partitionBy("l_orderkey").orderBy(F.col("l_quantity").desc())
    return df.withColumn("r", F.rank().over(w)).filter(F.col("r") <= 1)


def top_line_oracle(li, lines):
    """(keys, quantities) of every line whose quantity is its order's
    largest, ties kept, sorted by (key, quantity)."""
    starts = np.r_[0, np.cumsum(lines)[:-1]]
    best = np.maximum.reduceat(li["l_quantity"], starts)
    keep = li["l_quantity"] == np.repeat(best, lines)
    return li["l_orderkey"][keep], li["l_quantity"][keep]


def make_matrix_data(rows: int):
    """The window matrix's columns, from seed 45: g 1000 keys and o 1000
    order values with ties, v integer-valued doubles and i int32 (sums of
    both are exact in any order), x random doubles, u unique; nulls in g,
    o, v and i.  For ROADMAP C1's frames: f half-integer doubles with NaN,
    +-inf and -0.0, and e int64 values at both ends of the range, both with
    nulls."""
    rng = np.random.default_rng(SEED + 3)

    def nullable(a, p):
        return np.ma.MaskedArray(a, mask=rng.random(rows) < p)
    f = rng.integers(-20, 20, rows) / 2.0
    special = rng.random(rows) < 0.05
    f[special] = np.array([np.nan, np.inf, -np.inf, -0.0])[
        rng.integers(0, 4, int(special.sum()))]
    edges = np.array([-(1 << 63), -(1 << 63) + 2, -(1 << 62), 0, 1 << 62,
                      (1 << 63) - 3, (1 << 63) - 1])
    return {"f": nullable(f, 0.02),
            "e": nullable(edges[rng.integers(0, edges.size, rows)], 0.02),
            "g": nullable(rng.integers(0, 1000, rows), 0.01),
            "o": nullable(rng.integers(0, 1000, rows), 0.02),
            "v": nullable(rng.integers(-50, 50, rows).astype(np.float64),
                          0.1),
            "x": rng.random(rows),
            "i": nullable(rng.integers(-1000, 1000, rows).astype(np.int32),
                          0.1),
            "u": np.arange(rows, dtype=np.int64)}


def window_matrix(df, F, Window):
    """Every ported window function, with ROWS and RANGE frames (peers,
    numeric offsets ascending and descending, unbounded and numeric mixed)
    and a window without keys."""
    w = Window.partitionBy("g").orderBy("o")
    wdesc = Window.partitionBy("g").orderBy(F.col("o").desc())
    wu = Window.partitionBy("g").orderBy("u")
    sliding = wu.rowsBetween(-2, 2)
    return df.select(
        "u",
        F.row_number().over(wu).alias("rn"), F.rank().over(w).alias("rk"),
        F.dense_rank().over(wdesc).alias("dr"),
        F.percent_rank().over(w).alias("pr"),
        F.cume_dist().over(w).alias("cd"), F.ntile(4).over(wu).alias("nt"),
        F.lag("v").over(wu).alias("lag"),
        F.lead("i", 2, 7).over(wu).alias("lead"),
        F.sum("v").over(wu).alias("rsum"),
        F.count("v").over(sliding).alias("scnt"),
        F.avg("v").over(sliding).alias("savg"),
        F.min("i").over(sliding).alias("smin"),
        F.max("v").over(wu.rowsBetween(Window.unboundedPreceding, 1))
        .alias("hmax"),
        F.sum("v").over(w).alias("peer_sum"),
        F.sum("v").over(w.rangeBetween(-5, 5)).alias("rng_sum"),
        F.count("*").over(w.rangeBetween(-5, 5)).alias("rng_n"),
        F.count("v").over(wdesc.rangeBetween(-3, 0)).alias("desc_cnt"),
        F.sum("i").over(w.rangeBetween(Window.unboundedPreceding, 2))
        .alias("mixed_sum"),
        F.sum("x").over(wu).alias("xsum"),
        F.row_number().over(Window.orderBy("u")).alias("rn_all"),
        F.count("*").over(Window.partitionBy("g").orderBy("f")
                          .rangeBetween(-1, 1)).alias("c1_f"),
        F.count("*").over(Window.partitionBy("g").orderBy(F.col("f").desc())
                          .rangeBetween(-2, Window.unboundedFollowing))
        .alias("c1_fd"),
        F.count("*").over(Window.partitionBy("g").orderBy("e")
                          .rangeBetween(-3, 3)).alias("c1_e"))


def check_same_tables(a, b, label: str, summed=(), scale: float = 0.0,
                      key: str = "u"):
    """Two results of one query, rows matched by ``key``: nulls and values
    exact (NaN equal to NaN), but the ``summed`` columns (frame sums of
    random doubles) within rtol 1e-9 plus 1e-9 of ``scale``, the largest
    prefix they subtract."""
    if a.column_names != b.column_names or a.num_rows != b.num_rows:
        raise AssertionError(f"{label}: {a.num_rows} rows of "
                             f"{a.column_names} vs {b.num_rows} of "
                             f"{b.column_names}")
    oa = np.argsort(np.ma.getdata(a.column(key)))
    ob = np.argsort(np.ma.getdata(b.column(key)))
    for name in a.column_names:
        ca, cb = a.column(name)[oa], b.column(name)[ob]
        ma, mb = np.ma.getmaskarray(ca), np.ma.getmaskarray(cb)
        if not np.array_equal(ma, mb):
            raise AssertionError(f"{label}: nulls of {name} differ")
        da, db = np.ma.getdata(ca)[~ma], np.ma.getdata(cb)[~mb]
        if name in summed:
            np.testing.assert_allclose(da, db, rtol=RTOL_F64,
                                       atol=RTOL_F64 * scale,
                                       err_msg=f"{label} {name}")
        elif not np.array_equal(da, db, equal_nan=np.issubdtype(
                da.dtype, np.floating)):
            raise AssertionError(f"{label}: {name} differs")


def exchange_above_group_limit(plan) -> bool:
    """Whether the plan has an exchange with a WindowGroupLimitExec below
    it."""
    from spark_rapids_tpu_torch.sql.physical.window import \
        WindowGroupLimitExec

    def has(node):
        return isinstance(node, WindowGroupLimitExec) or any(
            has(c) for c in node.children)
    return any(any(has(c) for c in e.children) for e in exchanges_of(plan))


# --------------------------------------------------------------------------
# phase 3g: strings -- TPC-H q1 by its string keys, and the string matrix
# --------------------------------------------------------------------------

#: the rig's lineitem columns that TPC-H q1 reads, in its draw order
TPCH_Q1_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax",
                   "l_returnflag", "l_linestatus", "l_shipdate"]
#: q1's shipdate cutoff (TPC-H 2.4.1: 1998-12-01 minus 90 days)
TPCH_Q1_CUTOFF = "1998-09-02"


#: testing/tpch_queries.py's value lists, in its order
TPCH_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                   "5-LOW"]
TPCH_P_TYPES = ["PROMO BURNISHED COPPER", "PROMO PLATED BRASS",
                "STANDARD POLISHED TIN", "ECONOMY ANODIZED STEEL",
                "MEDIUM BRUSHED NICKEL"]
TPCH_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1)]
TPCH_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
TPCH_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                 "HOUSEHOLD"]
TPCH_SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
TPCH_SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                     "TAKE BACK RETURN"]
TPCH_CONTAINERS = ["SM CASE", "SM BOX", "SM PACK", "SM PKG", "MED BAG",
                   "MED BOX", "MED PKG", "MED PACK", "LG CASE", "LG BOX",
                   "LG PACK", "LG PKG", "JUMBO BAG", "JUMBO BOX",
                   "WRAP CASE", "WRAP BOX"]
TPCH_COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cream",
    "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral",
    "forest", "frosted", "gainsboro", "ghost", "gold", "goldenrod", "green",
    "grey", "honeydew", "hot", "hotpink", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen"]
TPCH_ORDER_COMMENTS = ["carefully final deposits", "furiously even asymptot",
                       "quickly regular pinto beans", "ironic packages wake",
                       "express special packages requests",
                       "blithely bold theodolites"]
TPCH_CUSTOMER_COMMENTS = ["ironic ideas", "silent accounts", "bold requests"]
TPCH_SUPPLIER_COMMENTS = ["blithely regular packages",
                          "furiously final ideas",
                          "slyly ironic Customer deposits Complaints haggle",
                          "carefully even theodolites"]
#: the probabilities of o_comment's six, o_orderstatus's three and
#: s_comment's four values
TPCH_COMMENT_P = [0.24, 0.24, 0.24, 0.2, 0.015, 0.065]
TPCH_STATUS_P = [0.49, 0.49, 0.02]
TPCH_SUPPLIER_COMMENT_P = [0.4, 0.35, 0.05, 0.2]


def scalar_draws(rng, ranges, n: int):
    """[n, len(ranges)] int64: the values of n rounds of scalar
    ``rng.integers(lo, hi)`` calls, one per range in turn, with the stream
    left where those calls leave it.  Each such call maps one 32-bit draw
    to its range by Lemire's multiply; a draw that this rejects (about one
    in 2^32 / range) takes the scalar calls themselves."""
    state = rng.bit_generator.state
    k = len(ranges)
    u = rng.integers(0, 1 << 32, size=n * k, dtype=np.uint32).astype(
        np.uint64)
    r = np.tile(np.array([hi - lo for lo, hi in ranges], dtype=np.uint64), n)
    m = u * r
    if ((m & 0xFFFFFFFF) < (((1 << 32) - r) % r)).any():
        rng.bit_generator.state = state
        return np.array([[rng.integers(lo, hi) for lo, hi in ranges]
                         for _ in range(n)], dtype=np.int64).reshape(n, k)
    lows = np.tile(np.array([lo for lo, _ in ranges], dtype=np.int64), n)
    return ((m >> np.uint64(32)).astype(np.int64) + lows).reshape(n, k)


def _numbered(prefix: str, values, width: int = 0):
    """``f"{prefix}{v:0{width}d}"`` for each value, as a numpy str array."""
    digits = np.asarray(values).astype(str)
    if width:
        digits = np.char.zfill(digits, width)
    return np.char.add(prefix, digits)


def make_tpch_tables(rows: int, seed: int = TPCH_SEED):
    """The JAX package's TPC-H tables (``testing/tpch_queries.py``
    ``build_tables``, seed 23), all eight with every column: the same
    draws from the same stream, in its order, with ``rows`` lineitem rows,
    rows // 4 orders, rows // 8 customers and parts, max(rows // 600, 10)
    suppliers, 4 partsupp rows a part, 25 nations and 5 regions.  The
    customers' phones interleave two scalar draws a row
    (``scalar_draws``); each part's name is two distinct colours drawn
    per row, ``rng.choice(47, 2, replace=False)`` (the draws of the
    reference's ``rng.choice(_COLORS, 2, replace=False)``), one call a
    part.  Strings are numpy str arrays, dates datetime64[D]."""
    rng = np.random.default_rng(seed)
    base = np.datetime64("1992-01-01")
    n_ord, n_cust, n_part = (max(rows // 4, 1), max(rows // 8, 1),
                             max(rows // 8, 1))
    n_supp = max(rows // 600, 10)
    stride = max(n_supp // 4, 1)
    ship = base + rng.integers(0, 2526, rows).astype("timedelta64[D]")
    l_orderkey = rng.integers(0, n_ord, rows)
    l_partkey = rng.integers(0, n_part, rows)
    li = {
        "l_quantity": rng.integers(1, 51, rows).astype(np.float64),
        "l_extendedprice": np.round(rng.random(rows) * 104949 + 901, 2),
        "l_discount": np.round(rng.integers(0, 11, rows) * 0.01, 2),
        "l_tax": np.round(rng.integers(0, 9, rows) * 0.01, 2),
        "l_returnflag": np.array(["A", "N", "R"])[rng.choice(3, rows)],
        "l_linestatus": np.array(["O", "F"])[rng.choice(2, rows)],
        "l_shipdate": ship.astype("datetime64[D]"),
        "l_orderkey": l_orderkey, "l_partkey": l_partkey,
        "l_commitdate": (ship + rng.integers(-30, 31, rows).astype(
            "timedelta64[D]")).astype("datetime64[D]"),
        "l_receiptdate": (ship + rng.integers(1, 31, rows).astype(
            "timedelta64[D]")).astype("datetime64[D]"),
    }
    li["l_suppkey"] = (l_partkey + rng.integers(0, 4, rows) * stride
                       ) % n_supp
    li["l_shipmode"] = np.array(TPCH_SHIPMODES)[rng.choice(7, rows)]
    li["l_shipinstruct"] = np.array(TPCH_SHIPINSTRUCT)[rng.choice(4, rows)]

    odate = base + rng.integers(0, 2406, n_ord).astype("timedelta64[D]")
    o_comment = np.array(TPCH_ORDER_COMMENTS)[
        rng.choice(6, n_ord, p=TPCH_COMMENT_P)]
    orders = {"o_orderkey": np.arange(n_ord),
              "o_custkey": rng.integers(0, 2 * n_cust, n_ord),
              "o_orderdate": odate.astype("datetime64[D]"),
              "o_orderpriority": np.array(TPCH_PRIORITIES)[
                  rng.choice(5, n_ord)],
              "o_totalprice": np.round(rng.random(n_ord) * 450000 + 850, 2),
              "o_shippriority": np.zeros(n_ord, dtype=np.int32),
              "o_orderstatus": np.array(["F", "O", "P"])[
                  rng.choice(3, n_ord, p=TPCH_STATUS_P)],
              "o_comment": o_comment}

    cc = rng.integers(10, 35, n_cust)
    phone = scalar_draws(rng, [(100, 999), (1000, 9999)], n_cust)
    customer = {
        "c_custkey": np.arange(n_cust),
        "c_phone": np.char.add(np.char.add(np.char.add(
            cc.astype(str), "-"), np.char.add(phone[:, 0].astype(str), "-")),
            phone[:, 1].astype(str)),
        "c_acctbal": np.round(rng.random(n_cust) * 10998.99 - 999.99, 2),
        "c_name": _numbered("Customer#", np.arange(n_cust), 9),
        "c_address": _numbered("addr ", np.arange(n_cust) % 997),
        "c_nationkey": rng.integers(0, 25, n_cust),
        "c_mktsegment": np.array(TPCH_SEGMENTS)[rng.choice(5, n_cust)],
        "c_comment": np.array(TPCH_CUSTOMER_COMMENTS)[
            rng.choice(3, n_cust)]}

    colors = np.array(TPCH_COLORS)
    part = {"p_partkey": np.arange(n_part),
            "p_type": np.array(TPCH_P_TYPES)[rng.choice(5, n_part)]}
    pick = np.array([rng.choice(len(TPCH_COLORS), 2, replace=False)
                     for _ in range(n_part)]).reshape(n_part, 2)
    part["p_name"] = np.char.add(np.char.add(colors[pick[:, 0]], " "),
                                 colors[pick[:, 1]])
    brand_m = rng.integers(1, 6, n_part)
    brand_n = rng.integers(1, 6, n_part)
    part["p_brand"] = np.char.add(_numbered("Brand#", brand_m),
                                  brand_n.astype(str))
    part["p_container"] = np.array(TPCH_CONTAINERS)[rng.choice(16, n_part)]
    part["p_size"] = rng.integers(1, 51, n_part)
    part["p_mfgr"] = _numbered("Manufacturer#", rng.integers(1, 6, n_part))
    part["p_retailprice"] = np.round(900 + rng.random(n_part) * 1200, 2)

    s_comment = np.array(TPCH_SUPPLIER_COMMENTS)[
        rng.choice(4, n_supp, p=TPCH_SUPPLIER_COMMENT_P)]
    i = np.arange(n_supp)
    supplier = {
        "s_suppkey": i, "s_name": _numbered("Supplier#", i, 9),
        "s_address": _numbered("saddr ", i % 499),
        "s_nationkey": rng.integers(0, 25, n_supp),
        "s_phone": np.char.add(np.char.add(np.char.add(
            (10 + i % 25).astype(str), "-"), (100 + i % 900).astype(str)),
            "-0000"),
        "s_acctbal": np.round(rng.random(n_supp) * 10998.99 - 999.99, 2),
        "s_comment": s_comment}

    ps_partkey = np.repeat(np.arange(n_part), 4)
    partsupp = {
        "ps_partkey": ps_partkey,
        "ps_suppkey": (ps_partkey + np.tile(np.arange(4), n_part) * stride
                       ) % n_supp,
        "ps_availqty": rng.integers(1, 10000, 4 * n_part),
        "ps_supplycost": np.round(rng.random(4 * n_part) * 999 + 1, 2)}
    nation = {"n_nationkey": np.arange(25),
              "n_name": np.array([n for n, _ in TPCH_NATIONS]),
              "n_regionkey": np.array([r for _, r in TPCH_NATIONS])}
    region = {"r_regionkey": np.arange(5), "r_name": np.array(TPCH_REGIONS)}
    return {"lineitem": li, "orders": orders, "part": part,
            "customer": customer, "supplier": supplier,
            "partsupp": partsupp, "nation": nation, "region": region}


def tpch_q1(df, F):
    """TPC-H q1 as the rig's ``_tpch_q1`` writes it
    (``testing/scaletest.py:179-200``)."""
    import datetime
    cutoff = datetime.date.fromisoformat(TPCH_Q1_CUTOFF)
    return (df.filter(df.l_shipdate <= F.lit(cutoff))
            .withColumn("disc_price",
                        df.l_extendedprice * (1.0 - df.l_discount))
            .withColumn("charge", df.l_extendedprice
                        * (1.0 - df.l_discount) * (1.0 + df.l_tax))
            .groupBy("l_returnflag", "l_linestatus")
            .agg(F.sum(F.col("l_quantity")).alias("sum_qty"),
                 F.sum(F.col("l_extendedprice")).alias("sum_base_price"),
                 F.sum(F.col("disc_price")).alias("sum_disc_price"),
                 F.sum(F.col("charge")).alias("sum_charge"),
                 F.avg(F.col("l_quantity")).alias("avg_qty"),
                 F.avg(F.col("l_extendedprice")).alias("avg_price"),
                 F.avg(F.col("l_discount")).alias("avg_disc"),
                 F.count("*").alias("count_order"))
            .orderBy("l_returnflag", "l_linestatus"))


def tpch_q1_oracle(li):
    """q1 in numpy: the groups by the two one-character keys' code points
    (their byte order), float64 bincount sums."""
    keep = li["l_shipdate"] <= np.datetime64(TPCH_Q1_CUTOFF)
    rf = li["l_returnflag"][keep].view(np.uint32).astype(np.int64)
    ls = li["l_linestatus"][keep].view(np.uint32).astype(np.int64)
    code = rf * 0x110000 + ls
    groups, inv = np.unique(code, return_inverse=True)
    qty, price = li["l_quantity"][keep], li["l_extendedprice"][keep]
    disc, tax = li["l_discount"][keep], li["l_tax"][keep]

    def gsum(v):
        return np.bincount(inv, weights=v, minlength=groups.size)
    cnt = np.bincount(inv, minlength=groups.size)
    return {
        "l_returnflag": np.array([chr(c) for c in groups // 0x110000]),
        "l_linestatus": np.array([chr(c) for c in groups % 0x110000]),
        "sum_qty": gsum(qty), "sum_base_price": gsum(price),
        "sum_disc_price": gsum(price * (1.0 - disc)),
        "sum_charge": gsum(price * (1.0 - disc) * (1.0 + tax)),
        "avg_qty": gsum(qty) / cnt, "avg_price": gsum(price) / cnt,
        "avg_disc": gsum(disc) / cnt, "count_order": cnt}


def check_rows(table, want, label: str) -> None:
    """Every column of the oracle, in its order: strings and integers
    exact, doubles within RTOL_F64; no nulls."""
    n = len(next(iter(want.values())))
    if table.num_rows != n or table.column_names != list(want):
        raise AssertionError(f"{label}: {table.num_rows} rows of "
                             f"{table.column_names}, want {n} of "
                             f"{list(want)}")
    for name, w in want.items():
        col = table.column(name)
        if np.ma.getmaskarray(col).any():
            raise AssertionError(f"{label}: nulls in {name}")
        got = np.ma.getdata(col)
        if np.issubdtype(np.asarray(w).dtype, np.floating):
            np.testing.assert_allclose(got, w, rtol=RTOL_F64,
                                       err_msg=f"{label} {name}")
        elif not np.array_equal(got, w):
            raise AssertionError(f"{label}: column {name} differs")


#: characters of 1 to 4 UTF-8 bytes for the string matrix
MATRIX_CHARS = [ord(c) for c in "abcdefxyzAZ09 _-"] + [
    ord(c) for c in "éßÿ中文😀"]


def make_string_matrix_data(rows: int):
    """The string matrix's columns, from seed 46: s random strings of 0 to
    12 characters of 1 to 4 UTF-8 bytes (width 64) with nulls; k one of
    5,000 keys sharing their first 8 bytes ("customer" and a number); v
    integer-valued doubles; u unique."""
    rng = np.random.default_rng(SEED + 4)
    chars = np.array(MATRIX_CHARS, dtype=np.uint32)
    cp = chars[rng.integers(0, chars.size, (rows, 12))]
    cp[np.arange(12)[None, :] >= rng.integers(0, 13, rows)[:, None]] = 0
    s = cp.view("<U12").reshape(rows)
    keys = np.array([f"customer{i:05d}" for i in range(5000)])
    return {"s": np.ma.MaskedArray(s, mask=rng.random(rows) < 0.05),
            "k": keys[rng.integers(0, keys.size, rows)],
            "v": rng.integers(-50, 50, rows).astype(np.float64),
            "u": np.arange(rows, dtype=np.int64)}


def string_matrix(df, dim, F, Window):
    """The string queries of the matrix: a sort, a group-by with min/max,
    a join and a window, each with a unique column to match rows by."""
    w = Window.partitionBy("k").orderBy("u")
    return {
        "sort": df.orderBy(F.col("s").desc(), "u").select("s", "u"),
        "group": (df.groupBy("k")
                  .agg(F.count("*").alias("n"), F.min("s").alias("mn"),
                       F.max("s").alias("mx"), F.sum("v").alias("sv"))
                  .select(F.col("k").alias("u"), "n", "mn", "mx", "sv")),
        "join": (df.join(dim, df["k"] == dim["dk"], "left")
                 .select("u", "s", "dk", "dv")),
        "window": df.select(
            "u", F.lead("s").over(w).alias("ld"),
            F.lag("s", 1, "none").over(w).alias("lg"),
            F.min("s").over(w.rowsBetween(-2, 2)).alias("mn"),
            F.max("k").over(Window.partitionBy("s")).alias("kx")),
    }


def c1_cases(sess, F, Window):
    """ROADMAP C1's three cases (NaN, +inf, +-2^62 order keys under
    rangeBetween(-1, 1)): each row's frame holds only itself, by Spark's
    rule."""
    cases = {"nan": ([1, 1, 1], np.array([1.0, np.nan, 3.0])),
             "inf": ([1, 1, 1, 2, 2], np.array([1.0, np.inf, 3.0, -1.0, 2.0])),
             "int62": ([1, 1, 1], np.array([-(1 << 62), 0, 1 << 62]))}
    for name, (g, v) in cases.items():
        df = sess.create_dataframe({"g": np.array(g, dtype=np.int64), "v": v,
                                    "u": np.arange(len(g), dtype=np.int64)})
        w = Window.partitionBy("g").orderBy("v").rangeBetween(-1, 1)
        got = df.select("u", F.count("u").over(w).alias("c")).collect()
        c = np.ma.getdata(got.column("c"))[np.argsort(np.ma.getdata(
            got.column("u")))]
        if c.tolist() != [1] * len(g):
            raise AssertionError(f"C1 {name}: counts {c.tolist()}, Spark "
                                 f"gives {[1] * len(g)}")


def range_kernels(prof, name: str):
    """(device ms, kernel launches) of the kernels launched inside every
    ``record_function(name)`` range of a profile: its CPU range, its
    children's, and the kernels each launched."""
    import torch
    total_us, launches = 0.0, 0

    def walk(e):
        nonlocal total_us, launches
        for k in getattr(e, "kernels", []):
            total_us += k.duration
            launches += 1
        for c in e.cpu_children:
            walk(c)
    for e in prof.events():
        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
            walk(e)
    return total_us / 1e3, launches


# --------------------------------------------------------------------------
# phase 3h: the scale rig's ten DataFrame queries, and the scalar matrix
# --------------------------------------------------------------------------

#: the scale rig's fact rows here (testing/scaletest.py build_tables, with
#: rows // 100 dimension keys): 6,000,000 until phase 3p needed the time
#: (the cut ROADMAP.md names first: 3h at a smaller scale); phases 3m, 3o
#: and 3p read the same table
RIG_ROWS = 3_000_000
#: the rig's data seed (build_tables)
RIG_SEED = 17
#: testing/datagen.py's StringGen alphabet (_DEFAULT_CHARS)
RIG_CHARS = ("abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 _-.,:/@")
#: StringGen(max_len=12)'s special values
RIG_STRING_SPECIALS = ["", " ", "NULL", "null", "0", "-1", "a" * 12, "é中ñ"]
#: DoubleGen(no_nans=True, no_extremes=True)'s special values
RIG_DOUBLE_SPECIALS = [0.0, -0.0, 1.0, -1.0, 2.2250738585072014e-308]
#: rows of the scalar-expression matrix, run on cuda and on the cpu
SCALAR_MATRIX_ROWS = MATRIX_ROWS


def rig_gen(rng, n: int, values, specials, nullable: bool = True):
    """testing/datagen.py ``DataGen.gen`` after its values: 5% of the rows
    take a special value, then 8% are null where the column is nullable,
    from the same draws.  A masked array."""
    hits = rng.random(n) < 0.05
    picks = rng.integers(0, len(specials), n)
    values = np.where(hits, np.asarray(specials, dtype=values.dtype)[picks],
                      values)
    mask = rng.random(n) < 0.08 if nullable else np.zeros(n, dtype=bool)
    return np.ma.MaskedArray(values, mask=mask)


def rig_strings(rng, n: int, max_len: int = 12):
    """StringGen's values, built with numpy instead of row by row: each
    row's length, then all rows' characters in one draw."""
    lens = rng.integers(0, max_len + 1, n)
    total = int(lens.sum())
    chars = rng.integers(0, len(RIG_CHARS), total)
    alphabet = np.array([ord(c) for c in RIG_CHARS], dtype=np.uint32)
    cp = np.zeros((n, max_len), dtype=np.uint32)
    row = np.repeat(np.arange(n), lens)
    cp[row, np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)] = \
        alphabet[chars]
    return cp.view(f"<U{max_len}").reshape(n)


def make_rig_tables(rows: int, seed: int = RIG_SEED):
    """testing/scaletest.py ``build_tables``: a fact table (v doubles with
    nulls, q ints 0..100, s strings of up to 12 characters with nulls, k
    keys with 20% of the rows on 1% of the rows // 100 keys) and a
    dimension (w, cat 0..8, k), each column from its own stream
    (``gen_table``), as numpy."""
    rng = np.random.default_rng(seed)
    n_keys = max(rows // 100, 10)
    hot = rng.integers(0, max(n_keys // 100, 1), rows // 5)
    cold = rng.integers(0, n_keys, rows - rows // 5)
    keys = np.concatenate([hot, cold])
    rng.shuffle(keys)

    def stream(s, i):
        return np.random.default_rng([s, i])
    r = stream(seed, 0)
    fact = {"v": rig_gen(r, rows, (r.random(rows) - 0.5) * 2e12,
                         RIG_DOUBLE_SPECIALS)}
    r = stream(seed, 1)
    fact["q"] = rig_gen(r, rows, r.integers(0, 101, rows, dtype=np.int64),
                        [0, 100, 0, 1, -1], nullable=False).astype(np.int32)
    r = stream(seed, 2)
    fact["s"] = rig_gen(r, rows, rig_strings(r, rows), RIG_STRING_SPECIALS)
    fact["k"] = keys
    r = stream(seed + 1, 0)
    dim = {"w": rig_gen(r, n_keys, (r.random(n_keys) - 0.5) * 2e12,
                        RIG_DOUBLE_SPECIALS, nullable=False)}
    r = stream(seed + 1, 1)
    dim["cat"] = rig_gen(r, n_keys, r.integers(0, 9, n_keys, dtype=np.int64),
                         [0, 8, 0, 1, -1], nullable=False).astype(np.int32)
    dim["k"] = np.arange(n_keys)
    return {"fact": fact, "dim": dim}


class Collecting:
    """A callable behind ``collect()`` (``df.count`` for the rig's _q6, a
    phase 3o item), so that it is driven, timed and profiled as the
    queries are."""

    def __init__(self, fn):
        self.fn = fn

    def collect(self):
        return self.fn()


def _date(text: str):
    import datetime
    return datetime.date.fromisoformat(text)


def rig_q1(sess, t, F, Window):
    fact = sess.create_dataframe(t["fact"], num_partitions=4)
    return (fact.filter(fact.q < 50)
            .groupBy("q").agg(F.sum(fact.v).alias("sv"),
                              F.count("*").alias("c"))
            .orderBy("q"))


def rig_q2(sess, t, F, Window):
    fact = sess.create_dataframe(t["fact"], num_partitions=4)
    dim = sess.create_dataframe(t["dim"], num_partitions=2)
    return (fact.join(dim, on="k", how="inner")
            .groupBy("cat").agg(F.count("*").alias("n"),
                                F.sum(fact.v).alias("sv"))
            .orderBy("cat"))


def rig_q3(sess, t, F, Window):
    fact = sess.create_dataframe(t["fact"], num_partitions=4)
    dim = sess.create_dataframe(t["dim"], num_partitions=2)
    return (fact.join(dim, on="k", how="left")
            .filter(fact.q >= 90).select(fact.k, fact.v, dim.w)
            .orderBy("k", "v"))


def rig_q4(sess, t, F, Window):
    fact = sess.create_dataframe(t["fact"], num_partitions=2)
    w = Window.partitionBy("q").orderBy("v")
    return (fact.select(fact.q, fact.v, F.row_number().over(w).alias("rn"))
            .filter(F.col("rn") <= 3))


def rig_q5(sess, t, F, Window):
    fact = sess.create_dataframe(t["fact"], num_partitions=4)
    return (fact.orderBy(fact.v.desc_nulls_first(), "k")
            .select(fact.k, fact.v))


def rig_q6(sess, t, F, Window):
    fact = sess.create_dataframe(t["fact"], num_partitions=4)
    return Collecting(fact.select(F.upper(fact.s).alias("u"),
                                  F.length(fact.s).alias("ln"))
                      .filter(F.col("ln") > 4).count)


def rig_tpch_q1(sess, t, F, Window):
    return tpch_q1(sess.create_dataframe(t["lineitem"], num_partitions=4), F)


def rig_tpch_q4(sess, t, F, Window):
    o = sess.create_dataframe(t["orders"], num_partitions=4)
    li = sess.create_dataframe(t["lineitem"], num_partitions=4)
    late = li.filter(li.l_commitdate < li.l_receiptdate)
    lo, hi = _date("1993-07-01"), _date("1993-10-01")
    return (o.filter((o.o_orderdate >= F.lit(lo)) & (o.o_orderdate < F.lit(hi)))
            .join(late, o.o_orderkey == late.l_orderkey, how="left_semi")
            .groupBy("o_orderpriority")
            .agg(F.count("*").alias("order_count"))
            .orderBy("o_orderpriority"))


def rig_tpch_q6(sess, t, F, Window):
    li = sess.create_dataframe(t["lineitem"], num_partitions=4)
    lo, hi = _date("1994-01-01"), _date("1995-01-01")
    return (li.filter((li.l_shipdate >= F.lit(lo))
                      & (li.l_shipdate < F.lit(hi))
                      & (li.l_discount >= 0.05) & (li.l_discount <= 0.07)
                      & (li.l_quantity < 24.0))
            .agg(F.sum(F.col("l_extendedprice") * F.col("l_discount"))
                 .alias("revenue")))


def rig_tpch_q14(sess, t, F, Window):
    lo, hi = _date("1995-09-01"), _date("1995-10-01")
    li = sess.create_dataframe(t["lineitem"], num_partitions=4)
    p = sess.create_dataframe(t["part"], num_partitions=2)
    j = (li.filter((li.l_shipdate >= F.lit(lo)) & (li.l_shipdate < F.lit(hi)))
         .join(p, li.l_partkey == p.p_partkey))
    rev = j.l_extendedprice * (1.0 - j.l_discount)
    return j.agg((F.sum(F.when(j.p_type.startswith("PROMO"), rev)
                        .otherwise(0.0)) * 100.0
                  / F.sum(rev)).alias("promo_revenue"))


def _col(table, name):
    c = table.column(name)
    return np.ma.getdata(c), np.ma.getmaskarray(c)


def _groups(keys, values=None):
    """(sorted distinct keys, per-key counts, per-key sums of ``values``
    with nulls as 0)."""
    groups, inv = np.unique(keys, return_inverse=True)
    counts = np.bincount(inv, minlength=groups.size)
    if values is None:
        return groups, counts, None
    return groups, counts, np.bincount(
        inv, weights=np.ma.filled(values, 0.0), minlength=groups.size)


def rig_q1_check(got, t):
    """The rig's pandas oracle in numpy: groups by q, sums with the rig's
    np.allclose, counts exact."""
    f = t["fact"]
    keep = f["q"] < 50
    q, c, sv = _groups(np.ma.getdata(f["q"])[keep], f["v"][keep])
    gq, _ = _col(got, "q")
    gsv, gsv_null = _col(got, "sv")
    assert np.array_equal(gq, q), "q1: groups"
    assert np.allclose(np.where(gsv_null, 0.0, gsv), sv), "q1: sums"
    assert np.array_equal(_col(got, "c")[0], c), "q1: counts"


def rig_q2_check(got, t):
    f, d = t["fact"], t["dim"]
    cat, n, sv = _groups(d["cat"][f["k"]], f["v"])
    assert np.array_equal(_col(got, "cat")[0], cat), "q2: groups"
    assert np.array_equal(_col(got, "n")[0], n), "q2: counts"
    gsv, gsv_null = _col(got, "sv")
    assert np.allclose(np.where(gsv_null, 0.0, gsv), sv), "q2: sums"


def rig_q3_check(got, t):
    """Every fact row with q >= 90 once, by key; w the key's dimension
    value (every key has one)."""
    f, d = t["fact"], t["dim"]
    k = np.sort(f["k"][np.ma.getdata(f["q"]) >= 90])
    gk, _ = _col(got, "k")
    gw, gw_null = _col(got, "w")
    assert got.num_rows == k.size and np.array_equal(gk, k), "q3: keys"
    assert not gw_null.any() and np.array_equal(gw, np.ma.getdata(
        d["w"])[k]), "q3: w"


def rig_q4_check(got, t):
    """row_number() <= 3 per q: at most 3 rows a group, and at least one
    less than the group's non-null v rows up to 3 (the rig's check)."""
    f = t["fact"]
    q = np.ma.getdata(f["q"])[~np.ma.getmaskarray(f["v"])]
    eq, ec, _ = _groups(q)
    gq, gc, _ = _groups(_col(got, "q")[0])
    have = dict(zip(gq.tolist(), gc.tolist()))
    assert gc.max() <= 3, "q4: more than 3 rows in a group"
    for key, cnt in zip(eq.tolist(), ec.tolist()):
        assert have.get(key, 0) >= min(3, cnt) - 1, f"q4: group {key}"


def rig_q5_check(got, t):
    """Every row, v descending with its nulls first."""
    v, null = _col(got, "v")
    assert got.num_rows == t["fact"]["v"].size, "q5: rows"
    n_null = int(np.ma.getmaskarray(t["fact"]["v"]).sum())
    assert null[:n_null].all() and not null[n_null:].any(), "q5: nulls"
    assert np.all(np.diff(v[n_null:]) <= 1e-12), "q5: not descending"


def rig_q6_check(got, t):
    """Rows whose s has more than 4 characters (code points)."""
    s = t["fact"]["s"]
    want = int(((np.char.str_len(np.ma.getdata(s)) > 4)
                & ~np.ma.getmaskarray(s)).sum())
    assert got == want, f"q6: count {got}, want {want}"


def rig_tpch_q1_check(got, t):
    check_rows(got, tpch_q1_oracle(t["lineitem"]), "tpch_q1")


def rig_tpch_q4_check(got, t):
    li, o = t["lineitem"], t["orders"]
    late = np.unique(li["l_orderkey"][li["l_commitdate"]
                                      < li["l_receiptdate"]])
    sel = ((o["o_orderdate"] >= np.datetime64("1993-07-01"))
           & (o["o_orderdate"] < np.datetime64("1993-10-01"))
           & np.isin(o["o_orderkey"], late))
    prio, cnt = np.unique(o["o_orderpriority"][sel], return_counts=True)
    assert _col(got, "o_orderpriority")[0].tolist() == prio.tolist(), \
        "tpch_q4: priorities"
    assert np.array_equal(_col(got, "order_count")[0], cnt), \
        "tpch_q4: counts"


def rig_tpch_q6_check(got, t):
    li = t["lineitem"]
    m = ((li["l_shipdate"] >= np.datetime64("1994-01-01"))
         & (li["l_shipdate"] < np.datetime64("1995-01-01"))
         & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
         & (li["l_quantity"] < 24.0))
    want = float((li["l_extendedprice"][m] * li["l_discount"][m]).sum())
    assert np.allclose(_col(got, "revenue")[0], want), "tpch_q6"


def rig_tpch_q14_check(got, t):
    li, p = t["lineitem"], t["part"]
    m = ((li["l_shipdate"] >= np.datetime64("1995-09-01"))
         & (li["l_shipdate"] < np.datetime64("1995-10-01")))
    rev = li["l_extendedprice"][m] * (1.0 - li["l_discount"][m])
    promo = np.char.startswith(p["p_type"][li["l_partkey"][m]], "PROMO")
    want = 100.0 * rev[promo].sum() / rev.sum()
    assert np.allclose(_col(got, "promo_revenue")[0], want), "tpch_q14"


#: the rig's QUERIES (testing/scaletest.py:590-600): name, query, oracle
RIG_QUERIES = [
    ("q1_filter_agg", rig_q1, rig_q1_check),
    ("q2_join_agg", rig_q2, rig_q2_check),
    ("q3_skewed_left_join", rig_q3, rig_q3_check),
    ("q4_window_topn", rig_q4, rig_q4_check),
    ("q5_global_sort", rig_q5, rig_q5_check),
    ("q6_strings", rig_q6, rig_q6_check),
    ("tpch_q1", rig_tpch_q1, rig_tpch_q1_check),
    ("tpch_q4_semi_join", rig_tpch_q4, rig_tpch_q4_check),
    ("tpch_q6", rig_tpch_q6, rig_tpch_q6_check),
    ("tpch_q14_promo_case", rig_tpch_q14, rig_tpch_q14_check),
]
#: the hand kernels that the rig's queries must launch between them
RIG_KERNELS = ("seg_sum_f32", "seg_sum_f64", "murmur3_long")


def make_scalar_matrix_data(rows: int):
    """The scalar matrix's columns, from seed 47: i and l ints near 0 and
    at their limits, d doubles with NaN, +-inf, -0.0 and huge values, v
    integer-valued doubles, b booleans, s strings of 1- to 4-byte
    characters, dt dates from 0001-01-01 to 9999-12-31, k 1,000 group
    keys and g a value that each key determines; nulls in all but u, k, v
    and g."""
    rng = np.random.default_rng(SEED + 5)

    def edges(values, picks, p=0.1):
        hit = rng.random(rows) < p
        values[hit] = np.asarray(picks, dtype=values.dtype)[
            rng.integers(0, len(picks), int(hit.sum()))]
        return np.ma.MaskedArray(values, mask=rng.random(rows) < 0.1)
    i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)
    chars = np.array(MATRIX_CHARS, dtype=np.uint32)
    cp = chars[rng.integers(0, chars.size, (rows, 10))]
    cp[np.arange(10)[None, :] >= rng.integers(0, 11, rows)[:, None]] = 0
    k = rng.integers(0, 1000, rows)
    return {
        "u": np.arange(rows, dtype=np.int64), "k": k, "g": k * 7 - 3,
        "i": edges(rng.integers(-9, 10, rows).astype(np.int32),
                   [i32.min, i32.max, 0, -1]),
        "l": edges(rng.integers(-9, 10, rows),
                   [i64.min, i64.max, 1 << 40, -1]),
        "d": edges(np.round(rng.normal(0, 3, rows), 1),
                   [np.nan, np.inf, -np.inf, -0.0, 1e300, 3e9, 2.5]),
        "v": rng.integers(-50, 50, rows).astype(np.float64),
        "b": np.ma.MaskedArray(rng.random(rows) < 0.5,
                               mask=rng.random(rows) < 0.1),
        "s": edges(cp.view("<U10").reshape(rows), ["", "é中ñ", "a_c",
                                                   "PROMO x"]),
        "dt": edges(rng.integers(-719162, 2932897, rows).astype(
            "datetime64[D]"), [np.datetime64("0001-01-01"),
                               np.datetime64("9999-12-31"),
                               np.datetime64("1970-01-01")]),
    }


def scalar_matrix(df, F):
    """Every expression the scalar slice ports, over the matrix: a select
    of row-wise expressions, a grouped aggregate of expressions over
    aggregates with first/last of a per-key value, and a filter's count."""
    import datetime
    rows = df.select(
        "u",
        (df.i == df.l).alias("eq"), (df.i != 3).alias("ne"),
        df.d.eqNullSafe(df.v).alias("ens"), (df.b | (df.i > 0)).alias("or_"),
        (~df.b).alias("not_"), df.d.isNull().alias("isnull"),
        df.s.isNotNull().alias("isnotnull"), F.isnan(df.d).alias("isnan"),
        df.i.isin(0, 1, int(np.iinfo(np.int32).max)).alias("in_i"),
        df.s.isin("é中ñ", "", "a").alias("in_s"),
        df.d.isin(float("nan"), 2.5, None).alias("in_d"),
        df.l.between(-2, 2).alias("between"),
        F.when(df.i > 0, df.s).when(df.i < 0, F.lit("negative, and long"))
        .otherwise(F.lit("z")).alias("cw"),
        F.when(df.b, df.d).alias("cw_null"),
        F.coalesce(df.d, df.v).alias("coalesce"),
        F.nanvl(df.d, df.v).alias("nanvl"),
        df.i.cast("bigint").alias("c_il"), df.l.cast("int").alias("c_li"),
        df.d.cast("int").alias("c_di"), df.d.cast("bigint").alias("c_dl"),
        df.d.cast("float").alias("c_df"), df.b.cast("int").alias("c_bi"),
        df.i.cast("boolean").alias("c_ib"), df.i.cast("double").alias("c_id"),
        F.length("s").alias("len"), F.octet_length("s").alias("octets"),
        F.upper("s").alias("upper"), F.lower("s").alias("lower"),
        F.substring("s", 2, 3).alias("sub"),
        F.substring("s", -3, 2).alias("sub_neg"),
        df.s.contains("中").alias("contains"),
        df.s.startswith("a").alias("startswith"),
        df.s.endswith("😀").alias("endswith"),
        df.s.like("a%").alias("like"), df.s.like("%_é%").alias("like_u"),
        F.year("dt").alias("year"), F.month("dt").alias("month"),
        F.dayofmonth("dt").alias("day"), F.dayofweek("dt").alias("dow"),
        F.dayofyear("dt").alias("doy"), F.weekofyear("dt").alias("woy"),
        F.quarter("dt").alias("quarter"), F.last_day("dt").alias("last_day"),
        F.date_add("dt", 30).alias("date_add"),
        F.date_sub("dt", 7).alias("date_sub"),
        F.datediff("dt", F.lit(datetime.date(2000, 1, 1))).alias("datediff"))
    groups = (df.groupBy("k")
              .agg((F.sum("v") * 100.0 / F.count("*")).alias("ratio"),
                   (F.max("i") - F.min("i")).alias("spread"),
                   (F.col("k") + 1).alias("k1"),
                   F.first("g").alias("first"), F.last("g").alias("last"),
                   F.first("g", True).alias("first_nn"),
                   F.sum(F.when(df.s.startswith("a"), df.v).otherwise(0.0))
                   .alias("case_sum")))
    kept = Collecting(df.filter((df.b | df.d.isNull()) & ~df.s.isin("", "a")
                                & (F.year("dt") > 1900)).count)
    return {"rows": rows, "groups": groups, "count": kept}


def back_to_back_ms(torch, launch, launches: int = 256) -> float:
    """Device ms a launch over one run of ``launches`` calls ``launch(i)``
    back to back, CUDA events around the run.  A sleep kernel keeps the
    card busy while the host enqueues them, so the run measures the kernels
    and not the wrappers' host time; it fails if the host took longer to
    enqueue the run than the sleep lasted."""
    sleep_start = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    sleep_start.record()
    torch.cuda._sleep(100_000_000)
    start.record()
    t0 = time.perf_counter()
    for i in range(launches):
        launch(i)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host_ms >= sleep_start.elapsed_time(start):
        raise AssertionError(f"back to back: the host took {host_ms:.3f} ms "
                             "to enqueue, longer than the sleep ahead")
    return start.elapsed_time(end) / launches


def murmur3_back_to_back(K, torch, n: int = 1 << 21, launches: int = 256,
                         buffers: int = 8):
    """murmur3_long back to back (:func:`back_to_back_ms`) at Q18's
    data-carrying shape.  The launches cycle over ``buffers`` inputs of n
    int64 (128 MB at 2^21, well past the 50 MB L2), so each finds its input
    in device memory.  Returns ms per launch for a scalar and a per-row
    seed."""
    rng = np.random.default_rng(SEED + 6)
    i64 = np.iinfo(np.int64)
    values = [torch.from_numpy(rng.integers(i64.min, i64.max, n,
                                            dtype=np.int64)).cuda()
              for _ in range(buffers)]
    seeds = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
    out = {}
    for label, seed in (("scalar", 42), ("per-row", seeds)):
        for v in values:
            K.murmur3_long(v, seed)
        out[label] = back_to_back_ms(
            torch, lambda i: K.murmur3_long(values[i % buffers], seed),
            launches)
    return out


def pcg64_back_to_back(torch, draw, n: int = 1 << 21, launches: int = 256,
                       ring: int = 8) -> float:
    """A pcg64 build back to back (:func:`back_to_back_ms`) at a rand()
    partition's 2^21 draws: ``draw(offset, n)`` returns the draws of one
    launch, each launch from the next offset.  The last ``ring`` outputs
    stay alive (128 MB at 2^21, well past the 50 MB L2), so no launch
    writes lines that the one before it left in L2."""
    live = [None] * ring

    def launch(i):
        live[i % ring] = draw(i * n, n)
    for i in range(ring):
        launch(i)
    return back_to_back_ms(torch, launch, launches)


# --------------------------------------------------------------------------
# phase 3i: the scale rig's 21 TPC-H SQL queries through session.sql
# --------------------------------------------------------------------------

#: testing/tpch_queries.py's 16 spec queries (QUERY_SET), as it writes them
TPCH_Q2 = """
SELECT s.s_acctbal, s.s_name, n.n_name, p.p_partkey, p.p_mfgr
FROM part p, supplier s, partsupp ps, nation n, region r
WHERE p.p_partkey = ps.ps_partkey AND s.s_suppkey = ps.ps_suppkey
  AND p.p_size = 15 AND p.p_type LIKE '%BRASS'
  AND s.s_nationkey = n.n_nationkey AND n.n_regionkey = r.r_regionkey
  AND r.r_name = 'EUROPE'
  AND ps.ps_supplycost = (SELECT min(ps2.ps_supplycost)
                          FROM partsupp ps2, supplier s2, nation n2,
                               region r2
                          WHERE ps2.ps_partkey = p.p_partkey
                            AND s2.s_suppkey = ps2.ps_suppkey
                            AND s2.s_nationkey = n2.n_nationkey
                            AND n2.n_regionkey = r2.r_regionkey
                            AND r2.r_name = 'EUROPE')
ORDER BY s.s_acctbal DESC, n.n_name, s.s_name, p.p_partkey
LIMIT 100
"""

TPCH_Q3 = """
SELECT l.l_orderkey,
       sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue,
       o.o_orderdate, o.o_shippriority
FROM customer c, orders o, lineitem l
WHERE c.c_mktsegment = 'BUILDING' AND c.c_custkey = o.o_custkey
  AND l.l_orderkey = o.o_orderkey
  AND o.o_orderdate < date '1995-03-15' AND l.l_shipdate > date '1995-03-15'
GROUP BY l.l_orderkey, o.o_orderdate, o.o_shippriority
ORDER BY revenue DESC, o.o_orderdate
LIMIT 10
"""

TPCH_Q5 = """
SELECT n.n_name, sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue
FROM customer c, orders o, lineitem l, supplier s, nation n, region r
WHERE c.c_custkey = o.o_custkey AND l.l_orderkey = o.o_orderkey
  AND l.l_suppkey = s.s_suppkey AND c.c_nationkey = s.s_nationkey
  AND s.s_nationkey = n.n_nationkey AND n.n_regionkey = r.r_regionkey
  AND r.r_name = 'ASIA'
  AND o.o_orderdate >= date '1994-01-01'
  AND o.o_orderdate < date '1995-01-01'
GROUP BY n.n_name
ORDER BY revenue DESC
"""

TPCH_Q7 = """
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
             year(l.l_shipdate) AS l_year,
             l.l_extendedprice * (1 - l.l_discount) AS volume
      FROM supplier s, lineitem l, orders o, customer c,
           nation n1, nation n2
      WHERE s.s_suppkey = l.l_suppkey AND o.o_orderkey = l.l_orderkey
        AND c.c_custkey = o.o_custkey
        AND s.s_nationkey = n1.n_nationkey
        AND c.c_nationkey = n2.n_nationkey
        AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
             OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
        AND l.l_shipdate BETWEEN date '1995-01-01' AND date '1996-12-31'
     ) shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year
"""

TPCH_Q8 = """
SELECT o_year,
       sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END)
           / sum(volume) AS mkt_share
FROM (SELECT year(o.o_orderdate) AS o_year,
             l.l_extendedprice * (1 - l.l_discount) AS volume,
             n2.n_name AS nation
      FROM part p, supplier s, lineitem l, orders o, customer c,
           nation n1, nation n2, region r
      WHERE p.p_partkey = l.l_partkey AND s.s_suppkey = l.l_suppkey
        AND l.l_orderkey = o.o_orderkey AND o.o_custkey = c.c_custkey
        AND c.c_nationkey = n1.n_nationkey
        AND n1.n_regionkey = r.r_regionkey AND r.r_name = 'AMERICA'
        AND s.s_nationkey = n2.n_nationkey
        AND o.o_orderdate BETWEEN date '1995-01-01' AND date '1996-12-31'
        AND p.p_type = 'ECONOMY ANODIZED STEEL') all_nations
GROUP BY o_year
ORDER BY o_year
"""

TPCH_Q9 = """
SELECT nation, o_year, sum(amount) AS sum_profit
FROM (SELECT n.n_name AS nation, year(o.o_orderdate) AS o_year,
             l.l_extendedprice * (1 - l.l_discount)
               - ps.ps_supplycost * l.l_quantity AS amount
      FROM part p, supplier s, lineitem l, partsupp ps, orders o, nation n
      WHERE s.s_suppkey = l.l_suppkey
        AND ps.ps_suppkey = l.l_suppkey AND ps.ps_partkey = l.l_partkey
        AND p.p_partkey = l.l_partkey AND o.o_orderkey = l.l_orderkey
        AND s.s_nationkey = n.n_nationkey
        AND p.p_name LIKE '%green%') profit
GROUP BY nation, o_year
ORDER BY nation, o_year DESC
"""

TPCH_Q10 = """
SELECT c.c_custkey, c.c_name,
       sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue,
       c.c_acctbal, n.n_name
FROM customer c, orders o, lineitem l, nation n
WHERE c.c_custkey = o.o_custkey AND l.l_orderkey = o.o_orderkey
  AND o.o_orderdate >= date '1993-10-01'
  AND o.o_orderdate < date '1994-01-01'
  AND l.l_returnflag = 'R' AND c.c_nationkey = n.n_nationkey
GROUP BY c.c_custkey, c.c_name, c.c_acctbal, n.n_name
ORDER BY revenue DESC
LIMIT 20
"""

TPCH_Q11 = """
SELECT ps.ps_partkey, sum(ps.ps_supplycost * ps.ps_availqty) AS value
FROM partsupp ps, supplier s, nation n
WHERE ps.ps_suppkey = s.s_suppkey AND s.s_nationkey = n.n_nationkey
  AND n.n_name = 'GERMANY'
GROUP BY ps.ps_partkey
HAVING sum(ps.ps_supplycost * ps.ps_availqty) >
       (SELECT sum(ps2.ps_supplycost * ps2.ps_availqty) * 0.005
        FROM partsupp ps2, supplier s2, nation n2
        WHERE ps2.ps_suppkey = s2.s_suppkey
          AND s2.s_nationkey = n2.n_nationkey AND n2.n_name = 'GERMANY')
ORDER BY value DESC
"""

TPCH_Q12 = """
SELECT l.l_shipmode,
       sum(CASE WHEN o.o_orderpriority = '1-URGENT'
                  OR o.o_orderpriority = '2-HIGH'
                THEN 1 ELSE 0 END) AS high_line_count,
       sum(CASE WHEN o.o_orderpriority <> '1-URGENT'
                 AND o.o_orderpriority <> '2-HIGH'
                THEN 1 ELSE 0 END) AS low_line_count
FROM orders o, lineitem l
WHERE o.o_orderkey = l.l_orderkey AND l.l_shipmode IN ('MAIL', 'SHIP')
  AND l.l_commitdate < l.l_receiptdate AND l.l_shipdate < l.l_commitdate
  AND l.l_receiptdate >= date '1994-01-01'
  AND l.l_receiptdate < date '1995-01-01'
GROUP BY l.l_shipmode
ORDER BY l.l_shipmode
"""

TPCH_Q13 = """
SELECT c_count, count(*) AS custdist
FROM (SELECT c.c_custkey AS c_custkey, count(o.o_orderkey) AS c_count
      FROM customer c LEFT JOIN
           (SELECT * FROM orders
            WHERE o_comment NOT LIKE '%special%requests%') o
           ON c.c_custkey = o.o_custkey
      GROUP BY c.c_custkey) c_orders
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
"""

TPCH_Q15 = """
WITH revenue AS
  (SELECT l_suppkey AS supplier_no,
          sum(l_extendedprice * (1 - l_discount)) AS total_revenue
   FROM lineitem
   WHERE l_shipdate >= date '1996-01-01' AND l_shipdate < date '1996-04-01'
   GROUP BY l_suppkey)
SELECT s.s_suppkey, s.s_name, total_revenue
FROM supplier s, revenue
WHERE s.s_suppkey = supplier_no
  AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s.s_suppkey
"""

TPCH_Q16 = """
SELECT p.p_brand, p.p_type, p.p_size,
       count(DISTINCT ps.ps_suppkey) AS supplier_cnt
FROM partsupp ps, part p
WHERE p.p_partkey = ps.ps_partkey AND p.p_brand <> 'Brand#45'
  AND p.p_type NOT LIKE 'MEDIUM POLISHED%'
  AND p.p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps.ps_suppkey NOT IN (SELECT s_suppkey FROM supplier
                            WHERE s_comment LIKE '%Customer%Complaints%')
GROUP BY p.p_brand, p.p_type, p.p_size
ORDER BY supplier_cnt DESC, p.p_brand, p.p_type, p.p_size
"""

TPCH_Q18 = """
SELECT c.c_name, c.c_custkey, o.o_orderkey, o.o_orderdate,
       o.o_totalprice, sum(l.l_quantity) AS total_qty
FROM customer c, orders o, lineitem l
WHERE o.o_orderkey IN (SELECT l_orderkey FROM lineitem
                       GROUP BY l_orderkey HAVING sum(l_quantity) > 180)
  AND c.c_custkey = o.o_custkey AND o.o_orderkey = l.l_orderkey
GROUP BY c.c_name, c.c_custkey, o.o_orderkey, o.o_orderdate, o.o_totalprice
ORDER BY o.o_totalprice DESC, o.o_orderdate
LIMIT 100
"""

TPCH_Q19 = """
SELECT sum(l.l_extendedprice * (1 - l.l_discount)) AS revenue
FROM lineitem l, part p
WHERE (p.p_partkey = l.l_partkey AND p.p_brand = 'Brand#12'
       AND p.p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
       AND l.l_quantity >= 1 AND l.l_quantity <= 11
       AND p.p_size BETWEEN 1 AND 5
       AND l.l_shipmode IN ('AIR', 'REG AIR')
       AND l.l_shipinstruct = 'DELIVER IN PERSON')
   OR (p.p_partkey = l.l_partkey AND p.p_brand = 'Brand#23'
       AND p.p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
       AND l.l_quantity >= 10 AND l.l_quantity <= 20
       AND p.p_size BETWEEN 1 AND 10
       AND l.l_shipmode IN ('AIR', 'REG AIR')
       AND l.l_shipinstruct = 'DELIVER IN PERSON')
   OR (p.p_partkey = l.l_partkey AND p.p_brand = 'Brand#34'
       AND p.p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
       AND l.l_quantity >= 20 AND l.l_quantity <= 30
       AND p.p_size BETWEEN 1 AND 15
       AND l.l_shipmode IN ('AIR', 'REG AIR')
       AND l.l_shipinstruct = 'DELIVER IN PERSON')
"""

TPCH_Q20 = """
SELECT s.s_name, s.s_address
FROM supplier s, nation n
WHERE s.s_suppkey IN
      (SELECT ps.ps_suppkey FROM partsupp ps
       WHERE ps.ps_partkey IN (SELECT p_partkey FROM part
                               WHERE p_name LIKE 'forest%')
         AND ps.ps_availqty > (SELECT 0.5 * sum(l.l_quantity)
                               FROM lineitem l
                               WHERE l.l_partkey = ps.ps_partkey
                                 AND l.l_suppkey = ps.ps_suppkey
                                 AND l.l_shipdate >= date '1994-01-01'
                                 AND l.l_shipdate < date '1995-01-01'))
  AND s.s_nationkey = n.n_nationkey AND n.n_name = 'CANADA'
ORDER BY s.s_name
"""

TPCH_Q21 = """
SELECT s.s_name, count(*) AS numwait
FROM supplier s, lineitem l1, orders o, nation n
WHERE s.s_suppkey = l1.l_suppkey AND o.o_orderkey = l1.l_orderkey
  AND o.o_orderstatus = 'F' AND l1.l_receiptdate > l1.l_commitdate
  AND EXISTS (SELECT 1 FROM lineitem l2
              WHERE l2.l_orderkey = l1.l_orderkey
                AND l2.l_suppkey <> l1.l_suppkey)
  AND NOT EXISTS (SELECT 1 FROM lineitem l3
                  WHERE l3.l_orderkey = l1.l_orderkey
                    AND l3.l_suppkey <> l1.l_suppkey
                    AND l3.l_receiptdate > l3.l_commitdate)
  AND s.s_nationkey = n.n_nationkey AND n.n_name = 'SAUDI ARABIA'
GROUP BY s.s_name
ORDER BY numwait DESC, s.s_name
LIMIT 100
"""

#: testing/scaletest.py's five SQL entries (:604-608), as it writes them
RIG_Q1_SQL = """
SELECT l_returnflag, l_linestatus,
       sum(l_quantity) AS sum_qty,
       sum(l_extendedprice) AS sum_base_price,
       sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
       sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
       avg(l_quantity) AS avg_qty,
       avg(l_extendedprice) AS avg_price,
       avg(l_discount) AS avg_disc,
       count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= CAST('1998-12-01' AS date) - INTERVAL '90' DAY
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

RIG_Q6_SQL = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= CAST('1994-01-01' AS date)
  AND l_shipdate < CAST('1995-01-01' AS date)
  AND l_discount BETWEEN 0.05 AND 0.07
  AND l_quantity < 24
"""

RIG_Q4_SQL = """
SELECT o_orderpriority, count(*) AS order_count
FROM orders
WHERE o_orderdate >= CAST('1993-07-01' AS date)
  AND o_orderdate < CAST('1993-10-01' AS date)
  AND EXISTS (
    SELECT 1 FROM lineitem
    WHERE lineitem.l_orderkey = orders.o_orderkey
      AND lineitem.l_commitdate < lineitem.l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""

RIG_Q22_SQL = """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal, c_custkey
      FROM customer
      WHERE substring(c_phone, 1, 2) IN ('13', '31', '23', '29', '30')
        AND c_acctbal > (SELECT avg(c_acctbal) FROM customer
                         WHERE c_acctbal > 0.00
                           AND substring(c_phone, 1, 2)
                               IN ('13', '31', '23', '29', '30'))) custsale
WHERE NOT EXISTS (SELECT 1 FROM orders
                  WHERE orders.o_custkey = custsale.c_custkey)
GROUP BY cntrycode
ORDER BY cntrycode
"""

RIG_Q17_SQL = (
    "SELECT sum(l.l_extendedprice) / 7.0 AS avg_yearly "
    "FROM lineitem l "
    "WHERE l.l_quantity < (SELECT 0.2 * avg(l2.l_quantity) "
    "FROM lineitem l2 WHERE l2.l_partkey = l.l_partkey)")


def _index(keys, q):
    """For each value of ``q``, its row in ``keys`` (unique values), -1
    where it is absent: the lookup side of an equi-join.  Keys 0..n-1 in
    order (the generator's primary keys) are their own rows."""
    keys = np.asarray(keys)
    q = np.asarray(q)
    if keys.dtype.kind == "i" and np.array_equal(
            keys, np.arange(keys.size, dtype=keys.dtype)):
        return np.where((q >= 0) & (q < keys.size), q, -1)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    if sk.size and np.any(sk[1:] == sk[:-1]):
        raise AssertionError("join keys of the oracle's lookup side repeat")
    if not sk.size:
        return np.full(np.shape(q), -1)
    pos = np.minimum(np.searchsorted(sk, q), sk.size - 1)
    return np.where(sk[pos] == q, order[pos], -1)


def _ps_key(partkey, suppkey):
    """partsupp's composite key as one int64."""
    return np.asarray(partkey) * (1 << 31) + np.asarray(suppkey)


def _year(d):
    return d.astype("datetime64[Y]").astype(np.int64) + 1970


def _rank(values):
    """Dense ranks of values (any sortable dtype), for lexsort keys."""
    return np.unique(values, return_inverse=True)[1]


def _sorted(cols, keys):
    """``cols`` (dict of equal-length arrays) reordered by ``keys``, a list
    of (array, ascending), as pandas ``sort_values`` with several keys
    orders them (stable)."""
    lex = [(_rank(a) if asc else -_rank(a)) for a, asc in keys]
    perm = np.lexsort(lex[::-1]) if lex else np.arange(0)
    return {k: np.asarray(v)[perm] for k, v in cols.items()}


def _as_list(values):
    return [v.item() if isinstance(v, np.generic) else v for v in values]


def check_ordered(got, exp, float_cols, exact_cols, label, limit=None):
    """``tpch_queries._check_ordered`` in numpy: with a LIMIT, the row
    count, the float sort columns in order (``np.allclose``) and the exact
    columns as members of the oracle's (ties may permute rows); without,
    every exact column in order and the float columns ``np.allclose``."""
    n = len(next(iter(exp.values())))
    if limit is not None:
        if got.num_rows != min(limit, n):
            raise AssertionError(f"{label}: {got.num_rows} rows, want "
                                 f"{min(limit, n)}")
        exp = {k: v[:limit] for k, v in exp.items()}
    elif got.num_rows != n:
        raise AssertionError(f"{label}: {got.num_rows} rows, want {n}")
    for c in float_cols:
        g = np.ma.getdata(got.column(c)).astype(np.float64)
        if not np.allclose(g, np.asarray(exp[c], dtype=np.float64)):
            raise AssertionError(f"{label}: column {c} differs")
    for c in exact_cols:
        g, e = _as_list(np.ma.getdata(got.column(c))), _as_list(exp[c])
        same = g == e or (limit is not None and set(g) <= set(e))
        if not same:
            raise AssertionError(f"{label}: column {c} differs")


def _group(keys, values=None, reduce="sum"):
    """(distinct key rows, per-group sums or counts) of aligned key
    arrays."""
    if len(keys) == 1:
        g, inv = np.unique(keys[0], return_inverse=True)
        out = [g]
    else:
        # one int64 code per row: the keys' dense ranks in mixed radix,
        # which sorts as the key tuples do
        code = np.zeros(len(keys[0]), dtype=np.int64)
        for k in keys:
            r = _rank(k)
            code = code * (int(r.max()) + 1 if r.size else 1) + r
        _, first, inv = np.unique(code, return_index=True,
                                  return_inverse=True)
        out = [np.asarray(k)[first] for k in keys]
    inv = inv.ravel()
    n = out[0].size
    if values is None:
        return out, np.bincount(inv, minlength=n)
    return out, np.bincount(inv, weights=values, minlength=n)


def _nation_of(t, nationkeys):
    return t["nation"]["n_name"][_index(t["nation"]["n_nationkey"],
                                        nationkeys)]


def _region_of(t, nationkeys):
    n = t["nation"]
    rk = n["n_regionkey"][_index(n["n_nationkey"], nationkeys)]
    return t["region"]["r_name"][_index(t["region"]["r_regionkey"], rk)]


def sql_q2_check(got, t):
    p, s, ps = t["part"], t["supplier"], t["partsupp"]
    pi = _index(p["p_partkey"], ps["ps_partkey"])
    si = _index(s["s_suppkey"], ps["ps_suppkey"])
    ok = (pi >= 0) & (si >= 0)
    pi, si, cost = pi[ok], si[ok], ps["ps_supplycost"][ok]
    ok = _region_of(t, s["s_nationkey"][si]) == "EUROPE"
    pi, si, cost = pi[ok], si[ok], cost[ok]
    pk = p["p_partkey"][pi]
    mins = np.full(pk.max() + 1 if pk.size else 1, np.inf)
    np.minimum.at(mins, pk, cost)
    sel = ((p["p_size"][pi] == 15) & np.char.endswith(p["p_type"][pi],
                                                       "BRASS")
           & (cost == mins[pk]))
    cols = {"s_acctbal": s["s_acctbal"][si][sel],
            "n_name": _nation_of(t, s["s_nationkey"][si][sel]),
            "s_name": s["s_name"][si][sel], "p_partkey": pk[sel]}
    exp = _sorted(cols, [(cols["s_acctbal"], False), (cols["n_name"], True),
                         (cols["s_name"], True), (cols["p_partkey"], True)])
    check_ordered(got, exp, ["s_acctbal"], ["p_partkey"], "q2", limit=100)


def _lineitem_orders_customers(t):
    """(lineitem rows with an order, their order rows, their customer rows,
    -1 where the order's customer is absent)."""
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    oi = _index(o["o_orderkey"], li["l_orderkey"])
    lrows = np.nonzero(oi >= 0)[0]
    oi = oi[lrows]
    ci = _index(c["c_custkey"], o["o_custkey"][oi])
    return lrows, oi, ci


def _revenue(li, rows):
    return li["l_extendedprice"][rows] * (1 - li["l_discount"][rows])


def sql_q3_check(got, t):
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    lr, oi, ci = _lineitem_orders_customers(t)
    cut = np.datetime64("1995-03-15")
    building = c["c_mktsegment"] == "BUILDING"
    ok = (ci >= 0) & building[np.maximum(ci, 0)]
    ok &= (o["o_orderdate"][oi] < cut) & (li["l_shipdate"][lr] > cut)
    (key,), rev = _group([li["l_orderkey"][lr][ok]], _revenue(li, lr[ok]))
    od = o["o_orderdate"][_index(o["o_orderkey"], key)]
    exp = _sorted({"l_orderkey": key, "revenue": rev},
                  [(rev, False), (od, True)])
    check_ordered(got, exp, ["revenue"], ["l_orderkey"], "q3", limit=10)


def sql_q5_check(got, t):
    li, o, c, s = t["lineitem"], t["orders"], t["customer"], t["supplier"]
    lr, oi, ci = _lineitem_orders_customers(t)
    si = _index(s["s_suppkey"], li["l_suppkey"][lr])
    ok = (ci >= 0) & (si >= 0)
    lr, oi, ci, si = lr[ok], oi[ok], ci[ok], si[ok]
    ok = c["c_nationkey"][ci] == s["s_nationkey"][si]
    ok &= _region_of(t, s["s_nationkey"][si]) == "ASIA"
    od = o["o_orderdate"][oi]
    ok &= (od >= np.datetime64("1994-01-01")) & (
        od < np.datetime64("1995-01-01"))
    (name,), rev = _group([_nation_of(t, s["s_nationkey"][si][ok])],
                          _revenue(li, lr[ok]))
    exp = _sorted({"n_name": name, "revenue": rev}, [(rev, False)])
    check_ordered(got, exp, ["revenue"], ["n_name"], "q5")


def sql_q7_check(got, t):
    li, c, s = t["lineitem"], t["customer"], t["supplier"]
    lr, oi, ci = _lineitem_orders_customers(t)
    si = _index(s["s_suppkey"], li["l_suppkey"][lr])
    ok = (ci >= 0) & (si >= 0)
    lr, ci, si = lr[ok], ci[ok], si[ok]
    n1 = _nation_of(t, s["s_nationkey"][si])
    n2 = _nation_of(t, c["c_nationkey"][ci])
    sd = li["l_shipdate"][lr]
    ok = ((sd >= np.datetime64("1995-01-01"))
          & (sd <= np.datetime64("1996-12-31"))
          & (((n1 == "FRANCE") & (n2 == "GERMANY"))
             | ((n1 == "GERMANY") & (n2 == "FRANCE"))))
    (a, b, y), rev = _group([n1[ok], n2[ok], _year(sd[ok])],
                            _revenue(li, lr[ok]))
    exp = _sorted({"supp_nation": a, "cust_nation": b, "l_year": y,
                   "revenue": rev}, [(a, True), (b, True), (y, True)])
    check_ordered(got, exp, ["revenue"],
                  ["supp_nation", "cust_nation", "l_year"], "q7")


def sql_q8_check(got, t):
    li, o, c, s, p = (t["lineitem"], t["orders"], t["customer"],
                      t["supplier"], t["part"])
    lr, oi, ci = _lineitem_orders_customers(t)
    si = _index(s["s_suppkey"], li["l_suppkey"][lr])
    pi = _index(p["p_partkey"], li["l_partkey"][lr])
    ok = (ci >= 0) & (si >= 0) & (pi >= 0)
    lr, oi, ci, si, pi = lr[ok], oi[ok], ci[ok], si[ok], pi[ok]
    od = o["o_orderdate"][oi]
    ok = ((_region_of(t, c["c_nationkey"][ci]) == "AMERICA")
          & (od >= np.datetime64("1995-01-01"))
          & (od <= np.datetime64("1996-12-31"))
          & (p["p_type"] == "ECONOMY ANODIZED STEEL")[pi])
    vol = _revenue(li, lr[ok])
    brazil = _nation_of(t, s["s_nationkey"][si][ok]) == "BRAZIL"
    (yr,), total = _group([_year(od[ok])], vol)
    _, part_b = _group([_year(od[ok])], np.where(brazil, vol, 0.0))
    check_ordered(got, {"o_year": yr, "mkt_share": part_b / total},
                  ["mkt_share"], ["o_year"], "q8")


def sql_q9_check(got, t):
    li, o, s, p, ps = (t["lineitem"], t["orders"], t["supplier"],
                       t["part"], t["partsupp"])
    pi = _index(p["p_partkey"], li["l_partkey"])
    si = _index(s["s_suppkey"], li["l_suppkey"])
    psi = _index(_ps_key(ps["ps_partkey"], ps["ps_suppkey"]),
                 _ps_key(li["l_partkey"], li["l_suppkey"]))
    oi = _index(o["o_orderkey"], li["l_orderkey"])
    lr = np.nonzero((pi >= 0) & (si >= 0) & (psi >= 0) & (oi >= 0))[0]
    green = np.char.find(p["p_name"], "green") >= 0
    lr = lr[green[pi[lr]]]
    amount = (_revenue(li, lr) - ps["ps_supplycost"][psi[lr]]
              * li["l_quantity"][lr])
    (nat, yr), tot = _group([_nation_of(t, s["s_nationkey"][si[lr]]),
                             _year(o["o_orderdate"][oi[lr]])], amount)
    exp = _sorted({"nation": nat, "o_year": yr, "sum_profit": tot},
                  [(nat, True), (yr, False)])
    check_ordered(got, exp, ["sum_profit"], ["nation", "o_year"], "q9")


def sql_q10_check(got, t):
    li, o, c = t["lineitem"], t["orders"], t["customer"]
    lr, oi, ci = _lineitem_orders_customers(t)
    od = o["o_orderdate"][oi]
    ok = ((ci >= 0) & (od >= np.datetime64("1993-10-01"))
          & (od < np.datetime64("1994-01-01"))
          & (li["l_returnflag"][lr] == "R"))
    (key,), rev = _group([c["c_custkey"][ci[ok]]], _revenue(li, lr[ok]))
    exp = _sorted({"c_custkey": key, "revenue": rev}, [(rev, False)])
    check_ordered(got, exp, ["revenue"], ["c_custkey"], "q10", limit=20)


def _german_partsupp(t):
    ps, s = t["partsupp"], t["supplier"]
    si = _index(s["s_suppkey"], ps["ps_suppkey"])
    ok = si >= 0
    ok[ok] = _nation_of(t, s["s_nationkey"][si[ok]]) == "GERMANY"
    return ok


def sql_q11_check(got, t):
    ps = t["partsupp"]
    ok = _german_partsupp(t)
    v = ps["ps_supplycost"][ok] * ps["ps_availqty"][ok]
    (key,), val = _group([ps["ps_partkey"][ok]], v)
    keep = val > val.sum() * 0.005
    exp = _sorted({"ps_partkey": key[keep], "value": val[keep]},
                  [(val[keep], False)])
    check_ordered(got, exp, ["value"], ["ps_partkey"], "q11")


def sql_q12_check(got, t):
    li, o = t["lineitem"], t["orders"]
    oi = _index(o["o_orderkey"], li["l_orderkey"])
    rd = li["l_receiptdate"]
    ok = ((oi >= 0) & np.isin(li["l_shipmode"], ["MAIL", "SHIP"])
          & (li["l_commitdate"] < rd)
          & (li["l_shipdate"] < li["l_commitdate"])
          & (rd >= np.datetime64("1994-01-01"))
          & (rd < np.datetime64("1995-01-01")))
    hi = np.isin(o["o_orderpriority"][oi[ok]], ["1-URGENT", "2-HIGH"])
    (mode,), high = _group([li["l_shipmode"][ok]], hi.astype(np.float64))
    _, n = _group([li["l_shipmode"][ok]])
    check_ordered(got, {"l_shipmode": mode,
                        "high_line_count": high.astype(np.int64),
                        "low_line_count": n - high.astype(np.int64)},
                  [], ["l_shipmode", "high_line_count", "low_line_count"],
                  "q12")


def _matches(values, pattern):
    """``Series.str.match(pattern)`` over a column of few distinct
    strings."""
    import re
    uniq, inv = np.unique(values, return_inverse=True)
    hit = np.array([re.match(pattern, u) is not None for u in uniq],
                   dtype=bool)
    return hit[inv.ravel()] if uniq.size else np.zeros(0, dtype=bool)


def sql_q13_check(got, t):
    o, c = t["orders"], t["customer"]
    keep = ~_matches(o["o_comment"], ".*special.*requests.*")
    ci = _index(c["c_custkey"], o["o_custkey"][keep])
    per_cust = np.bincount(ci[ci >= 0], minlength=c["c_custkey"].size)
    (cnt,), dist = _group([per_cust])
    exp = _sorted({"c_count": cnt, "custdist": dist},
                  [(dist, False), (cnt, False)])
    check_ordered(got, exp, [], ["c_count", "custdist"], "q13")


def sql_q15_check(got, t):
    li, s = t["lineitem"], t["supplier"]
    sd = li["l_shipdate"]
    ok = (sd >= np.datetime64("1996-01-01")) & (
        sd < np.datetime64("1996-04-01"))
    (supp,), rev = _group([li["l_suppkey"][ok]], _revenue(li, ok))
    best = rev == rev.max()
    keep = _index(s["s_suppkey"], supp[best]) >= 0
    exp = _sorted({"s_suppkey": supp[best][keep],
                   "total_revenue": rev[best][keep]},
                  [(supp[best][keep], True)])
    check_ordered(got, exp, ["total_revenue"], ["s_suppkey"], "q15")


def sql_q16_check(got, t):
    ps, p, s = t["partsupp"], t["part"], t["supplier"]
    bad = s["s_suppkey"][_matches(s["s_comment"],
                                  ".*Customer.*Complaints.*")]
    pi = _index(p["p_partkey"], ps["ps_partkey"])
    ok = pi >= 0
    pi, supp = pi[ok], ps["ps_suppkey"][ok]
    ok = ((p["p_brand"][pi] != "Brand#45")
          & ~np.char.startswith(p["p_type"][pi], "MEDIUM POLISHED")
          & np.isin(p["p_size"][pi], [49, 14, 23, 45, 19, 3, 36, 9])
          & ~np.isin(supp, bad))
    brand, typ, size = p["p_brand"][pi[ok]], p["p_type"][pi[ok]], \
        p["p_size"][pi[ok]]
    # distinct suppliers per group: the distinct (group, supplier) rows
    (b, ty, sz, _), _ = _group([brand, typ, size, supp[ok]])
    (b, ty, sz), cnt = _group([b, ty, sz])
    exp = _sorted({"p_brand": b, "p_type": ty, "p_size": sz,
                   "supplier_cnt": cnt},
                  [(cnt, False), (b, True), (ty, True), (sz, True)])
    check_ordered(got, exp, [], ["p_brand", "p_type", "p_size",
                                 "supplier_cnt"], "q16")


def sql_q18_check(got, t):
    li, o = t["lineitem"], t["orders"]
    (okeys,), qty = _group([li["l_orderkey"]], li["l_quantity"])
    big = okeys[qty > 180]
    lr, oi, ci = _lineitem_orders_customers(t)
    ok = (ci >= 0) & np.isin(o["o_orderkey"][oi], big)
    (key,), total = _group([o["o_orderkey"][oi[ok]]], li["l_quantity"][lr[ok]])
    ki = _index(o["o_orderkey"], key)
    exp = _sorted({"o_orderkey": key, "o_totalprice": o["o_totalprice"][ki],
                   "total_qty": total},
                  [(o["o_totalprice"][ki], False),
                   (o["o_orderdate"][ki], True)])
    check_ordered(got, exp, ["o_totalprice"], ["o_orderkey"], "q18",
                  limit=100)


def sql_q19_check(got, t):
    li, p = t["lineitem"], t["part"]
    pi = _index(p["p_partkey"], li["l_partkey"])
    lr = np.nonzero(pi >= 0)[0]
    pi = pi[lr]
    qty = li["l_quantity"][lr]
    common = (np.isin(li["l_shipmode"][lr], ["AIR", "REG AIR"])
              & (li["l_shipinstruct"][lr] == "DELIVER IN PERSON"))

    def branch(b, conts, lo, hi, top):
        part_ok = ((p["p_brand"] == b) & np.isin(p["p_container"], conts)
                   & (p["p_size"] >= 1) & (p["p_size"] <= top))
        return part_ok[pi] & (qty >= lo) & (qty <= hi)
    sel = common & (
        branch("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"],
               1, 11, 5)
        | branch("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"],
                 10, 20, 10)
        | branch("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"],
                 20, 30, 15))
    want = float(_revenue(li, lr[sel]).sum())
    val, null = _col(got, "revenue")
    val = 0.0 if null[0] else float(val[0])
    if not abs(val - want) <= 1e-6 * max(abs(want), 1.0):
        raise AssertionError(f"q19: {val}, want {want}")


def sql_q20_check(got, t):
    li, p, ps, s = t["lineitem"], t["part"], t["partsupp"], t["supplier"]
    sd = li["l_shipdate"]
    ok = (sd >= np.datetime64("1994-01-01")) & (
        sd < np.datetime64("1995-01-01"))
    (lk,), half = _group([_ps_key(li["l_partkey"][ok], li["l_suppkey"][ok])],
                         li["l_quantity"][ok])
    half = half * 0.5
    forest = p["p_partkey"][np.char.startswith(p["p_name"], "forest")]
    keep = np.isin(ps["ps_partkey"], forest)
    hi = _index(lk, _ps_key(ps["ps_partkey"][keep], ps["ps_suppkey"][keep]))
    th = np.where(hi >= 0, half[np.maximum(hi, 0)], np.nan)
    good = ps["ps_suppkey"][keep][ps["ps_availqty"][keep] > th]
    sel = ((_nation_of(t, s["s_nationkey"]) == "CANADA")
           & np.isin(s["s_suppkey"], good))
    exp = _sorted({"s_name": s["s_name"][sel], "s_address":
                   s["s_address"][sel]}, [(s["s_name"][sel], True)])
    check_ordered(got, exp, [], ["s_name", "s_address"], "q20")


def _distinct_suppliers(orderkeys, suppkeys):
    (ok_, _), _ = _group([orderkeys, suppkeys])
    return _group([ok_])


def sql_q21_check(got, t):
    li, o, s = t["lineitem"], t["orders"], t["supplier"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    (ko,), nsupp = _distinct_suppliers(li["l_orderkey"], li["l_suppkey"])
    (kl,), nlate = _distinct_suppliers(li["l_orderkey"][late],
                                       li["l_suppkey"][late])
    lr = np.nonzero(late)[0]
    si = _index(s["s_suppkey"], li["l_suppkey"][lr])
    oi = _index(o["o_orderkey"], li["l_orderkey"][lr])
    ok = (si >= 0) & (oi >= 0)
    lr, si, oi = lr[ok], si[ok], oi[ok]
    ok = ((o["o_orderstatus"][oi] == "F")
          & (_nation_of(t, s["s_nationkey"][si]) == "SAUDI ARABIA"))
    lr, si = lr[ok], si[ok]
    okey = li["l_orderkey"][lr]
    multi = nsupp[_index(ko, okey)] > 1
    only = nlate[_index(kl, okey)] == 1
    (name,), n = _group([s["s_name"][si][multi & only]])
    exp = _sorted({"s_name": name, "numwait": n},
                  [(n, False), (name, True)])
    check_ordered(got, exp, [], ["s_name", "numwait"], "q21", limit=100)


def sql_q22_check(got, t):
    c, o = t["customer"], t["orders"]
    codes = ["13", "31", "23", "29", "30"]
    cc = np.array([x[:2] for x in c["c_phone"].tolist()])
    inset = np.isin(cc, codes)
    avg = c["c_acctbal"][(c["c_acctbal"] > 0.0) & inset].mean()
    sel = inset & (c["c_acctbal"] > avg) & ~np.isin(c["c_custkey"],
                                                    o["o_custkey"])
    (code,), n = _group([cc[sel]])
    _, tot = _group([cc[sel]], c["c_acctbal"][sel])
    if _as_list(np.ma.getdata(got.column("cntrycode"))) != _as_list(code):
        raise AssertionError("q22: country codes differ")
    if not np.array_equal(_col(got, "numcust")[0], n):
        raise AssertionError("q22: counts differ")
    if not np.allclose(_col(got, "totacctbal")[0], tot):
        raise AssertionError("q22: balances differ")


def sql_q17_check(got, t):
    li = t["lineitem"]
    (pk,), total = _group([li["l_partkey"]], li["l_quantity"])
    _, n = _group([li["l_partkey"]])
    th = 0.2 * total / n
    sel = li["l_quantity"] < th[_index(pk, li["l_partkey"])]
    want = li["l_extendedprice"][sel].sum() / 7.0
    val = float(_col(got, "avg_yearly")[0][0])
    if not abs(val - want) <= 1e-9 * max(abs(want), 1.0):
        raise AssertionError(f"q17: {val}, want {want}")


#: the rig's 21 TPC-H SQL queries: name, text, numpy copy of its oracle,
#: and the column a test changes to see the oracle refuse an answer
SQL_QUERIES = [
    ("q2", TPCH_Q2, sql_q2_check, "p_partkey"),
    ("q3", TPCH_Q3, sql_q3_check, "l_orderkey"),
    ("q5", TPCH_Q5, sql_q5_check, "n_name"),
    ("q7", TPCH_Q7, sql_q7_check, "supp_nation"),
    ("q8", TPCH_Q8, sql_q8_check, "o_year"),
    ("q9", TPCH_Q9, sql_q9_check, "nation"),
    ("q10", TPCH_Q10, sql_q10_check, "c_custkey"),
    ("q11", TPCH_Q11, sql_q11_check, "ps_partkey"),
    ("q12", TPCH_Q12, sql_q12_check, "high_line_count"),
    ("q13", TPCH_Q13, sql_q13_check, "custdist"),
    ("q15", TPCH_Q15, sql_q15_check, "s_suppkey"),
    ("q16", TPCH_Q16, sql_q16_check, "supplier_cnt"),
    ("q18", TPCH_Q18, sql_q18_check, "o_orderkey"),
    ("q19", TPCH_Q19, sql_q19_check, "revenue"),
    ("q20", TPCH_Q20, sql_q20_check, "s_name"),
    ("q21", TPCH_Q21, sql_q21_check, "numwait"),
    ("tpch_q1_sql", RIG_Q1_SQL, rig_tpch_q1_check, "count_order"),
    ("tpch_q4_sql_exists", RIG_Q4_SQL, rig_tpch_q4_check, "order_count"),
    ("tpch_q22_sql_subqueries", RIG_Q22_SQL, sql_q22_check, "numcust"),
    ("tpch_q6_sql", RIG_Q6_SQL, rig_tpch_q6_check, "revenue"),
    ("tpch_q17_corr_scalar", RIG_Q17_SQL, sql_q17_check, "avg_yearly"),
]


# --------------------------------------------------------------------------
# phase 3k: decimals -- the 21 TPC-H SQL queries over decimal(12,2) money
# columns, and the decimal and arithmetic matrix
# --------------------------------------------------------------------------

#: the TPC-H money columns (spec 1.3.1: decimal, +-9,999,999,999.99 in
#: steps of 0.01), each decimal(12,2) in phase 3k's tables
DEC_MONEY = {"lineitem": ("l_quantity", "l_extendedprice", "l_discount",
                          "l_tax"),
             "orders": ("o_totalprice",), "customer": ("c_acctbal",),
             "supplier": ("s_acctbal",), "partsupp": ("ps_supplycost",),
             "part": ("p_retailprice",)}
DEC_PRECISION, DEC_SCALE = 12, 2
#: rows of phase 3k's decimal and arithmetic matrix, run on cuda and cpu
DECIMAL_MATRIX_ROWS = MATRIX_ROWS


def decimal_tpch_tables(t):
    """The TPC-H tables with every money column as its unscaled int64
    value at scale 2, ``round(x * 100)``; the other columns as they are."""
    return {name: {c: (np.round(v * 100).astype(np.int64)
                       if c in DEC_MONEY.get(name, ()) else v)
                   for c, v in cols.items()}
            for name, cols in t.items()}


def register_tpch_decimal_views(sess, td, parts: int = 4) -> None:
    """The decimal tables as views at ``parts`` partitions: each money
    column a decimal(12,2) column of its unscaled values."""
    from spark_rapids_tpu_torch.columnar import HostDecimals
    for name, cols in td.items():
        host = {c: (HostDecimals.from_unscaled(v, DEC_PRECISION, DEC_SCALE)
                    if c in DEC_MONEY.get(name, ()) else v)
                for c, v in cols.items()}
        sess.create_dataframe(host, num_partitions=parts) \
            .createOrReplaceTempView(name)


def _group_index(keys):
    """(distinct key rows in sorted order, each row's group, group
    count)."""
    if len(keys) == 1:
        g, inv = np.unique(keys[0], return_inverse=True)
        return [g], inv.ravel(), g.size
    code = np.zeros(len(keys[0]), dtype=np.int64)
    for k in keys:
        r = _rank(k)
        code = code * (int(r.max()) + 1 if r.size else 1) + r
    _, first, inv = np.unique(code, return_index=True, return_inverse=True)
    return [np.asarray(k)[first] for k in keys], inv.ravel(), first.size


def _sum_exact(inv, values, n: int) -> np.ndarray:
    """Exact per-group sums of int64 values below 2^50 in magnitude, as
    an object array of Python ints: each value's high and low 24 bits are
    summed apart in float64, where every partial sum is an integer below
    2^53."""
    v = np.asarray(values, dtype=np.int64)
    if v.size and int(np.abs(v).max()) >= 1 << 50:
        raise AssertionError("_sum_exact: a value of 2^50 or more")
    lo = np.bincount(inv, weights=(v & 0xFFFFFF).astype(np.float64),
                     minlength=n)
    hi = np.bincount(inv, weights=(v >> 24).astype(np.float64), minlength=n)
    out = np.empty(n, dtype=object)
    out[:] = [(int(h) << 24) + int(lw) for h, lw in zip(hi, lo)]
    return out


def _group_exact(keys, values):
    """(distinct key rows, exact per-group sums of int64 values)."""
    out, inv, n = _group_index(keys)
    return out, _sum_exact(inv, values, n)


def _half_up(num: int, den: int) -> int:
    """num / den rounded HALF_UP (away from zero on a tie), Spark's
    decimal division; Python ints."""
    q, r = divmod(abs(num), abs(den))
    if 2 * r >= abs(den):
        q += 1
    return -q if (num < 0) != (den < 0) else q


def _unscaled(got, name: str, scale: int) -> list:
    """A decimal result column as Python ints at ``scale`` (None where
    null)."""
    import decimal
    ctx = decimal.Context(prec=80)
    vals, nulls = _col(got, name)
    return [None if m else int(decimal.Decimal(v).scaleb(scale, ctx))
            for v, m in zip(vals.tolist(), nulls.tolist())]


def check_ordered_dec(got, exp, dec_cols, exact_cols, label, limit=None,
                      keyed=None):
    """``check_ordered`` for results with decimal columns: the columns are
    ``exp``'s; each of ``dec_cols`` (name -> scale) exact in order, as
    unscaled ints; ``exact_cols`` as ``check_ordered`` has them (with a
    LIMIT, members of the oracle's); ``keyed`` (key column, {column:
    (key -> unscaled value, scale)}) checks each returned row's value by
    its key, as ties under a LIMIT may permute rows."""
    if list(got.column_names) != list(exp):
        raise AssertionError(f"{label}: columns {got.column_names}, want "
                             f"{list(exp)}")
    n = len(next(iter(exp.values())))
    if limit is not None:
        n = min(limit, n)
        exp = {k: v[:n] for k, v in exp.items()}
    if got.num_rows != n:
        raise AssertionError(f"{label}: {got.num_rows} rows, want {n}")
    for c, scale in dec_cols.items():
        if _unscaled(got, c, scale) != [int(x) for x in exp[c]]:
            raise AssertionError(f"{label}: decimal column {c} differs")
    for c in exact_cols:
        g, e = _as_list(np.ma.getdata(got.column(c))), _as_list(exp[c])
        if not (g == e or (limit is not None and set(g) <= set(e))):
            raise AssertionError(f"{label}: column {c} differs")
    if keyed:
        key, cols = keyed
        keys = _as_list(np.ma.getdata(got.column(key)))
        for c, (want, scale) in cols.items():
            if _unscaled(got, c, scale) != [want[k] for k in keys]:
                raise AssertionError(f"{label}: {c} by {key} differs")


def _dec_revenue(li, rows):
    """l_extendedprice * (1 - l_discount): decimal(27,4), unscaled."""
    return li["l_extendedprice"][rows] * (100 - li["l_discount"][rows])


def dec_q1_check(got, td):
    li = td["lineitem"]
    keep = li["l_shipdate"] <= np.datetime64(TPCH_Q1_CUTOFF)
    (rf, ls), inv, n = _group_index([li["l_returnflag"][keep],
                                     li["l_linestatus"][keep]])
    q, p, d, x = (li[c][keep] for c in ("l_quantity", "l_extendedprice",
                                        "l_discount", "l_tax"))
    cnt = np.bincount(inv, minlength=n)
    sq, sp, sd = (_sum_exact(inv, v, n) for v in (q, p, d))
    disc = p * (100 - d)
    exp = {"l_returnflag": rf, "l_linestatus": ls, "sum_qty": sq,
           "sum_base_price": sp,
           "sum_disc_price": _sum_exact(inv, disc, n),
           # (27,4) times (1 + l_tax) cast to (27,4): scale 8
           "sum_charge": _sum_exact(inv, disc * ((100 + x) * 100), n),
           "avg_qty": [_half_up(s * 10 ** 4, c) for s, c in zip(sq, cnt)],
           "avg_price": [_half_up(s * 10 ** 4, c) for s, c in zip(sp, cnt)],
           "avg_disc": [_half_up(s * 10 ** 4, c) for s, c in zip(sd, cnt)],
           "count_order": cnt}
    check_ordered_dec(got, exp, {"sum_qty": 2, "sum_base_price": 2,
                                 "sum_disc_price": 4, "sum_charge": 8,
                                 "avg_qty": 6, "avg_price": 6,
                                 "avg_disc": 6},
                      ["l_returnflag", "l_linestatus", "count_order"], "q1")


def dec_q6_check(got, td):
    li = td["lineitem"]
    d = li["l_discount"] / 100.0        # decimal -> double: x / 10^scale
    m = ((li["l_shipdate"] >= np.datetime64("1994-01-01"))
         & (li["l_shipdate"] < np.datetime64("1995-01-01"))
         & (d >= 0.05) & (d <= 0.07) & (li["l_quantity"] < 2400))
    (want,) = _sum_exact(np.zeros(int(m.sum()), dtype=np.int64),
                         li["l_extendedprice"][m] * li["l_discount"][m], 1)
    check_ordered_dec(got, {"revenue": [want]}, {"revenue": 4}, [], "q6")


def dec_q2_check(got, td):
    p, s, ps = td["part"], td["supplier"], td["partsupp"]
    pi = _index(p["p_partkey"], ps["ps_partkey"])
    si = _index(s["s_suppkey"], ps["ps_suppkey"])
    ok = (pi >= 0) & (si >= 0)
    pi, si, cost = pi[ok], si[ok], ps["ps_supplycost"][ok]
    ok = _region_of(td, s["s_nationkey"][si]) == "EUROPE"
    pi, si, cost = pi[ok], si[ok], cost[ok]
    pk = p["p_partkey"][pi]
    mins = np.full(pk.max() + 1 if pk.size else 1, np.iinfo(np.int64).max)
    np.minimum.at(mins, pk, cost)
    sel = ((p["p_size"][pi] == 15) & np.char.endswith(p["p_type"][pi],
                                                       "BRASS")
           & (cost == mins[pk]))
    cols = {"s_acctbal": s["s_acctbal"][si][sel],
            "s_name": s["s_name"][si][sel],
            "n_name": _nation_of(td, s["s_nationkey"][si][sel]),
            "p_partkey": pk[sel], "p_mfgr": p["p_mfgr"][pi][sel]}
    exp = _sorted(cols, [(cols["s_acctbal"], False), (cols["n_name"], True),
                         (cols["s_name"], True), (cols["p_partkey"], True)])
    check_ordered_dec(got, exp, {"s_acctbal": 2}, ["p_partkey"], "q2",
                      limit=100)


def dec_q3_check(got, td):
    li, o, c = td["lineitem"], td["orders"], td["customer"]
    lr, oi, ci = _lineitem_orders_customers(td)
    cut = np.datetime64("1995-03-15")
    ok = (ci >= 0) & (c["c_mktsegment"] == "BUILDING")[np.maximum(ci, 0)]
    ok &= (o["o_orderdate"][oi] < cut) & (li["l_shipdate"][lr] > cut)
    (key,), rev = _group_exact([li["l_orderkey"][lr][ok]],
                               _dec_revenue(li, lr[ok]))
    ki = _index(o["o_orderkey"], key)
    exp = _sorted({"l_orderkey": key, "revenue": rev,
                   "o_orderdate": o["o_orderdate"][ki],
                   "o_shippriority": o["o_shippriority"][ki]},
                  [(rev, False), (o["o_orderdate"][ki], True)])
    check_ordered_dec(got, exp, {"revenue": 4}, ["l_orderkey"], "q3",
                      limit=10, keyed=("l_orderkey", {"revenue": (
                          dict(zip(key.tolist(), rev)), 4)}))


def dec_q5_check(got, td):
    li, o, c, s = td["lineitem"], td["orders"], td["customer"], \
        td["supplier"]
    lr, oi, ci = _lineitem_orders_customers(td)
    si = _index(s["s_suppkey"], li["l_suppkey"][lr])
    ok = (ci >= 0) & (si >= 0)
    lr, oi, ci, si = lr[ok], oi[ok], ci[ok], si[ok]
    ok = c["c_nationkey"][ci] == s["s_nationkey"][si]
    ok &= _region_of(td, s["s_nationkey"][si]) == "ASIA"
    od = o["o_orderdate"][oi]
    ok &= (od >= np.datetime64("1994-01-01")) & (
        od < np.datetime64("1995-01-01"))
    (name,), rev = _group_exact([_nation_of(td, s["s_nationkey"][si][ok])],
                                _dec_revenue(li, lr[ok]))
    exp = _sorted({"n_name": name, "revenue": rev}, [(rev, False)])
    check_ordered_dec(got, exp, {"revenue": 4}, ["n_name"], "q5")


def dec_q7_check(got, td):
    li, c, s = td["lineitem"], td["customer"], td["supplier"]
    lr, oi, ci = _lineitem_orders_customers(td)
    si = _index(s["s_suppkey"], li["l_suppkey"][lr])
    ok = (ci >= 0) & (si >= 0)
    lr, ci, si = lr[ok], ci[ok], si[ok]
    n1 = _nation_of(td, s["s_nationkey"][si])
    n2 = _nation_of(td, c["c_nationkey"][ci])
    sd = li["l_shipdate"][lr]
    ok = ((sd >= np.datetime64("1995-01-01"))
          & (sd <= np.datetime64("1996-12-31"))
          & (((n1 == "FRANCE") & (n2 == "GERMANY"))
             | ((n1 == "GERMANY") & (n2 == "FRANCE"))))
    (a, b, y), rev = _group_exact([n1[ok], n2[ok], _year(sd[ok])],
                                  _dec_revenue(li, lr[ok]))
    exp = _sorted({"supp_nation": a, "cust_nation": b, "l_year": y,
                   "revenue": rev}, [(a, True), (b, True), (y, True)])
    check_ordered_dec(got, exp, {"revenue": 4},
                      ["supp_nation", "cust_nation", "l_year"], "q7")


def dec_q8_check(got, td):
    li, o, c, s, p = (td["lineitem"], td["orders"], td["customer"],
                      td["supplier"], td["part"])
    lr, oi, ci = _lineitem_orders_customers(td)
    si = _index(s["s_suppkey"], li["l_suppkey"][lr])
    pi = _index(p["p_partkey"], li["l_partkey"][lr])
    ok = (ci >= 0) & (si >= 0) & (pi >= 0)
    lr, oi, ci, si, pi = lr[ok], oi[ok], ci[ok], si[ok], pi[ok]
    od = o["o_orderdate"][oi]
    ok = ((_region_of(td, c["c_nationkey"][ci]) == "AMERICA")
          & (od >= np.datetime64("1995-01-01"))
          & (od <= np.datetime64("1996-12-31"))
          & (p["p_type"] == "ECONOMY ANODIZED STEEL")[pi])
    vol = _dec_revenue(li, lr[ok])
    brazil = _nation_of(td, s["s_nationkey"][si][ok]) == "BRAZIL"
    (yr,), total = _group_exact([_year(od[ok])], vol)
    _, part_b = _group_exact([_year(od[ok])], np.where(brazil, vol, 0))
    # decimal(37,4) / decimal(37,4) is decimal(38,38): the quotient
    # times 10^38, HALF_UP
    share = [_half_up(b * 10 ** 38, tot) for b, tot in zip(part_b, total)]
    check_ordered_dec(got, {"o_year": yr, "mkt_share": share},
                      {"mkt_share": 38}, ["o_year"], "q8")


def dec_q9_check(got, td):
    li, o, s, p, ps = (td["lineitem"], td["orders"], td["supplier"],
                       td["part"], td["partsupp"])
    pi = _index(p["p_partkey"], li["l_partkey"])
    si = _index(s["s_suppkey"], li["l_suppkey"])
    psi = _index(_ps_key(ps["ps_partkey"], ps["ps_suppkey"]),
                 _ps_key(li["l_partkey"], li["l_suppkey"]))
    oi = _index(o["o_orderkey"], li["l_orderkey"])
    lr = np.nonzero((pi >= 0) & (si >= 0) & (psi >= 0) & (oi >= 0))[0]
    lr = lr[(np.char.find(p["p_name"], "green") >= 0)[pi[lr]]]
    amount = (_dec_revenue(li, lr) - ps["ps_supplycost"][psi[lr]]
              * li["l_quantity"][lr])
    (nat, yr), tot = _group_exact([_nation_of(td, s["s_nationkey"][si[lr]]),
                                   _year(o["o_orderdate"][oi[lr]])], amount)
    exp = _sorted({"nation": nat, "o_year": yr, "sum_profit": tot},
                  [(nat, True), (yr, False)])
    check_ordered_dec(got, exp, {"sum_profit": 4}, ["nation", "o_year"],
                      "q9")


def dec_q10_check(got, td):
    li, o, c = td["lineitem"], td["orders"], td["customer"]
    lr, oi, ci = _lineitem_orders_customers(td)
    od = o["o_orderdate"][oi]
    ok = ((ci >= 0) & (od >= np.datetime64("1993-10-01"))
          & (od < np.datetime64("1994-01-01"))
          & (li["l_returnflag"][lr] == "R"))
    (key,), rev = _group_exact([c["c_custkey"][ci[ok]]],
                               _dec_revenue(li, lr[ok]))
    ki = _index(c["c_custkey"], key)
    bal = c["c_acctbal"][ki]
    exp = _sorted({"c_custkey": key, "c_name": c["c_name"][ki],
                   "revenue": rev, "c_acctbal": bal,
                   "n_name": _nation_of(td, c["c_nationkey"][ki])},
                  [(rev, False)])
    check_ordered_dec(got, exp, {"revenue": 4}, ["c_custkey"], "q10",
                      limit=20, keyed=("c_custkey", {
                          "c_acctbal": (dict(zip(key.tolist(),
                                                 bal.tolist())), 2),
                          "revenue": (dict(zip(key.tolist(), rev)), 4)}))


def dec_q11_check(got, td):
    ps = td["partsupp"]
    ok = _german_partsupp(td)
    # ps_availqty is cast to decimal(12,2): the product has scale 4
    v = ps["ps_supplycost"][ok] * (ps["ps_availqty"][ok] * 100)
    (key,), val = _group_exact([ps["ps_partkey"][ok]], v)
    total = sum(val)
    # both sides of the HAVING compare as doubles: x / 10^4
    keep = np.array([float(x) / 1e4 for x in val]) \
        > (float(total) / 1e4) * 0.005
    exp = _sorted({"ps_partkey": key[keep], "value": val[keep]},
                  [(val[keep], False)])
    check_ordered_dec(got, exp, {"value": 4}, ["ps_partkey"], "q11")


def dec_q15_check(got, td):
    li, s = td["lineitem"], td["supplier"]
    sd = li["l_shipdate"]
    ok = (sd >= np.datetime64("1996-01-01")) & (
        sd < np.datetime64("1996-04-01"))
    (supp,), rev = _group_exact([li["l_suppkey"][ok]],
                                _dec_revenue(li, np.nonzero(ok)[0]))
    top = max(rev)
    best = np.array([r == top for r in rev], dtype=bool)
    si = _index(s["s_suppkey"], supp[best])
    keep = si >= 0
    exp = _sorted({"s_suppkey": supp[best][keep],
                   "s_name": s["s_name"][si[keep]],
                   "total_revenue": rev[best][keep]},
                  [(supp[best][keep], True)])
    check_ordered_dec(got, exp, {"total_revenue": 4}, ["s_suppkey"], "q15")


def dec_q17_check(got, td):
    li = td["lineitem"]
    (pk,), inv, n = _group_index([li["l_partkey"]])
    total = _sum_exact(inv, li["l_quantity"], n)
    cnt = np.bincount(inv, minlength=n)
    # avg(l_quantity) is decimal(16,6); 0.2 * it and the quantity compare
    # as doubles
    th = np.array([0.2 * (_half_up(s * 10 ** 4, k) / 1e6)
                   for s, k in zip(total, cnt)])
    sel = li["l_quantity"] / 100.0 < th[inv]
    (s,) = _sum_exact(np.zeros(int(sel.sum()), dtype=np.int64),
                      li["l_extendedprice"][sel], 1)
    want = (s / 100.0) / 7.0
    val = float(_col(got, "avg_yearly")[0][0])
    if not abs(val - want) <= RTOL_F64 * max(abs(want), 1.0):
        raise AssertionError(f"q17: {val}, want {want}")


def dec_q18_check(got, td):
    li, o, c = td["lineitem"], td["orders"], td["customer"]
    (okeys,), qty = _group_exact([li["l_orderkey"]], li["l_quantity"])
    big = okeys[np.array([q > 180 * 100 for q in qty], dtype=bool)]
    lr, oi, ci = _lineitem_orders_customers(td)
    ok = (ci >= 0) & np.isin(o["o_orderkey"][oi], big)
    (key,), total = _group_exact([o["o_orderkey"][oi[ok]]],
                                 li["l_quantity"][lr[ok]])
    ki = _index(o["o_orderkey"], key)
    ci2 = _index(c["c_custkey"], o["o_custkey"][ki])
    price = o["o_totalprice"][ki]
    exp = _sorted({"c_name": c["c_name"][ci2], "c_custkey": c["c_custkey"][
        ci2], "o_orderkey": key, "o_orderdate": o["o_orderdate"][ki],
        "o_totalprice": price, "total_qty": total},
        [(price, False), (o["o_orderdate"][ki], True)])
    check_ordered_dec(got, exp, {"o_totalprice": 2}, ["o_orderkey"], "q18",
                      limit=100, keyed=("o_orderkey", {"total_qty": (
                          dict(zip(key.tolist(), total)), 2)}))


def dec_q19_check(got, td):
    li, p = td["lineitem"], td["part"]
    pi = _index(p["p_partkey"], li["l_partkey"])
    lr = np.nonzero(pi >= 0)[0]
    pi = pi[lr]
    qty = li["l_quantity"][lr]
    common = (np.isin(li["l_shipmode"][lr], ["AIR", "REG AIR"])
              & (li["l_shipinstruct"][lr] == "DELIVER IN PERSON"))

    def branch(b, conts, lo, hi, top):
        part_ok = ((p["p_brand"] == b) & np.isin(p["p_container"], conts)
                   & (p["p_size"] >= 1) & (p["p_size"] <= top))
        return part_ok[pi] & (qty >= lo * 100) & (qty <= hi * 100)
    sel = common & (
        branch("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"],
               1, 11, 5)
        | branch("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"],
                 10, 20, 10)
        | branch("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"],
                 20, 30, 15))
    (want,) = _sum_exact(np.zeros(int(sel.sum()), dtype=np.int64),
                         _dec_revenue(li, lr[sel]), 1)
    check_ordered_dec(got, {"revenue": [want]}, {"revenue": 4}, [], "q19")


def dec_q20_check(got, td):
    li, p, ps, s = td["lineitem"], td["part"], td["partsupp"], \
        td["supplier"]
    sd = li["l_shipdate"]
    ok = (sd >= np.datetime64("1994-01-01")) & (
        sd < np.datetime64("1995-01-01"))
    (lk,), qty = _group_exact([_ps_key(li["l_partkey"][ok],
                                       li["l_suppkey"][ok])],
                              li["l_quantity"][ok])
    # 0.5 * sum(l_quantity): the decimal sum as a double
    half = np.array([0.5 * (q / 100.0) for q in qty])
    forest = p["p_partkey"][np.char.startswith(p["p_name"], "forest")]
    keep = np.isin(ps["ps_partkey"], forest)
    hi = _index(lk, _ps_key(ps["ps_partkey"][keep], ps["ps_suppkey"][keep]))
    th = np.where(hi >= 0, half[np.maximum(hi, 0)] if half.size else 0.0,
                  np.nan)
    good = ps["ps_suppkey"][keep][ps["ps_availqty"][keep] > th]
    sel = ((_nation_of(td, s["s_nationkey"]) == "CANADA")
           & np.isin(s["s_suppkey"], good))
    exp = _sorted({"s_name": s["s_name"][sel], "s_address":
                   s["s_address"][sel]}, [(s["s_name"][sel], True)])
    check_ordered(got, exp, [], ["s_name", "s_address"], "q20")


def dec_q22_check(got, td):
    c, o = td["customer"], td["orders"]
    codes = ["13", "31", "23", "29", "30"]
    cc = np.array([x[:2] for x in c["c_phone"].tolist()])
    inset = np.isin(cc, codes)
    pos = inset & (c["c_acctbal"] / 100.0 > 0.0)
    (s,) = _sum_exact(np.zeros(int(pos.sum()), dtype=np.int64),
                      c["c_acctbal"][pos], 1)
    avg = _half_up(s * 10 ** 4, int(pos.sum()))       # decimal(16,6)
    # c_acctbal meets the average at decimal(16,6)
    sel = inset & (c["c_acctbal"] * 10 ** 4 > avg) & ~np.isin(
        c["c_custkey"], o["o_custkey"])
    (code,), inv, n = _group_index([cc[sel]])
    exp = {"cntrycode": code, "numcust": np.bincount(inv, minlength=n),
           "totacctbal": _sum_exact(inv, c["c_acctbal"][sel], n)}
    check_ordered_dec(got, exp, {"totacctbal": 2}, ["cntrycode", "numcust"],
                      "q22")


#: the 21 TPC-H SQL texts of phase 3i over the decimal tables: name, text
#: and the numpy oracle over the unscaled values (the five that touch no
#: money column keep phase 3i's)
DEC_SQL_QUERIES = [
    ("q2", TPCH_Q2, dec_q2_check), ("q3", TPCH_Q3, dec_q3_check),
    ("q5", TPCH_Q5, dec_q5_check), ("q7", TPCH_Q7, dec_q7_check),
    ("q8", TPCH_Q8, dec_q8_check), ("q9", TPCH_Q9, dec_q9_check),
    ("q10", TPCH_Q10, dec_q10_check), ("q11", TPCH_Q11, dec_q11_check),
    ("q12", TPCH_Q12, sql_q12_check), ("q13", TPCH_Q13, sql_q13_check),
    ("q15", TPCH_Q15, dec_q15_check), ("q16", TPCH_Q16, sql_q16_check),
    ("q18", TPCH_Q18, dec_q18_check), ("q19", TPCH_Q19, dec_q19_check),
    ("q20", TPCH_Q20, dec_q20_check), ("q21", TPCH_Q21, sql_q21_check),
    ("tpch_q1_sql", RIG_Q1_SQL, dec_q1_check),
    ("tpch_q4_sql_exists", RIG_Q4_SQL, rig_tpch_q4_check),
    ("tpch_q22_sql_subqueries", RIG_Q22_SQL, dec_q22_check),
    ("tpch_q6_sql", RIG_Q6_SQL, dec_q6_check),
    ("tpch_q17_corr_scalar", RIG_Q17_SQL, dec_q17_check),
]


class SqlQuery:
    """One SQL text as the rig runs it: every ``collect()`` is
    ``sess.sql(text).collect()``, parse, plan (scalar subqueries are
    collected while the plan is built) and run."""

    def __init__(self, sess, text: str):
        self.sess = sess
        self.text = text

    def collect(self):
        return self.sess.sql(self.text).collect()


def register_tpch_views(sess, t, parts: int = 4) -> None:
    """``tpch_queries.register_views``: each table a view at ``parts``
    partitions."""
    for name, cols in t.items():
        sess.create_dataframe(cols, num_partitions=parts) \
            .createOrReplaceTempView(name)


def join_report(plan) -> list:
    """Each join of a plan that has run, in plan order: its exec class,
    type, equi-keys, whether it has a residual condition, and the build
    side's rows of a nested-loop join."""
    from spark_rapids_tpu_torch.sql.physical.join import (
        NestedLoopJoinExec, join_execs)
    out = []
    for j in join_execs(plan):
        e = {"exec": j.node_name(), "how": j.how, "keys": len(j._probe_keys),
             "condition": j.condition is not None}
        if isinstance(j, NestedLoopJoinExec):
            e["build_rows"] = j.build_rows
        out.append(e)
    return out


def run_sql_queries(srt, K, torch, tpch, by_path, err) -> dict:
    """Phase 3i: the 21 TPC-H SQL queries through ``session.sql`` over the
    tables ``tpch`` (SF 0.5) as views at 4 partitions, default
    configuration; each held
    against the numpy copy of its oracle, its hand-kernel calls replayed
    against the plain versions, its joins reported, q15 run three times.
    Returns each query's run (the query, cold seconds, launches, joins)."""
    phase("3i", f"the scale rig's 21 TPC-H SQL queries through "
        f"session.sql, TPC-H ({tpch['lineitem']['l_quantity'].size} lineitem "
        f"rows, seed {TPCH_SEED}), the 8 tables as views at 4 partitions, "
        "default configuration")
    sql_sess = srt.session()
    t0 = time.perf_counter()
    register_tpch_views(sql_sess, tpch)
    log(f"  views registered in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {len(next(iter(v.values())))}"
                    for k, v in tpch.items()))
    sql_runs = {}
    for name, text, check, _ in SQL_QUERIES:
        t_query = time.perf_counter()
        sql_query = SqlQuery(sql_sess, text)
        q_seg: dict = {}
        q_mm: list = []
        with recording_seg_sums(K, q_seg), \
                recording(K, "murmur3_long", q_mm):
            got, launches, cold_s = drive(f"sql {name}", sql_query.collect,
                                          K, torch, (), by_path)
        check_later(f"sql {name}", check, got, tpch)
        for kname in SEG_SUM_BUILDS:
            if q_seg[kname]:
                err[kname] = max(err[kname], check_seg_sum_calls(
                    K, torch, kname, f"sql {name}", q_seg[kname]))
        if q_mm:
            err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
                K, torch, f"sql {name}", q_mm))
        del q_seg, q_mm
        joins = join_report(sql_sess.last_plan)
        log(f"  sql {name}: {got.num_rows} rows (held against the numpy copy "
            f"of its oracle in the background); joins {json.dumps(joins)}")
        if name == "q15":
            # the revenue view is computed twice: the scalar subquery's max
            # and the outer rows must agree to the last bit, run after run
            for again in range(2):
                other = sql_query.collect()
                for a, b, label in zip(got.datas, other.datas,
                                       got.column_names):
                    if not np.array_equal(a, b):
                        raise AssertionError(f"q15: run {again + 2} differs "
                                             f"from run 1 in {label}")
            log("  sql q15: the same rows in three runs")
        sql_runs[name] = dict(query=sql_query, cold_s=cold_s,
                              launches=launches, joins=joins,
                              rows=got.num_rows)
        log(f"  sql {name}: run, checks and replays took "
            f"{time.perf_counter() - t_query:.2f} s")
    sql_launches = {k: sum(r["launches"][k] for r in sql_runs.values())
                    for k in RIG_KERNELS}
    log(f"  the SQL queries' launches of the hand kernels: {sql_launches}")
    for k, n in sql_launches.items():
        if n < 1:
            raise AssertionError(f"no SQL query launched {k}")
    return sql_runs


def sql_times(sql_runs: dict, torch) -> list:
    """Phase 4's part for the SQL queries: each cold, warm (one run after
    the cold one) and profiled once; printed as the ``sql`` JSON line."""
    log("  the 21 TPC-H SQL queries: cold, warm (one run after the cold "
        f"one), a profile of one warm run of {PROFILED['sql']}; each run "
        "parses, plans (scalar subqueries collected while planning) and "
        "collects")
    sql_report = []
    for qname, rr in sql_runs.items():
        t_query = time.perf_counter()
        wm, tms = warm_ms(rr["query"], torch, WARM_RUNS_3I_3J)
        log(f"  sql {qname}: cold {rr['cold_s'] * 1e3:.3f} ms; warm median "
            f"{wm:.3f} ms of {[round(t, 3) for t in tms]} ms")
        sql_report.append({
            "query": qname, "rows": rr["rows"],
            "cold_ms": rr["cold_s"] * 1e3, "warm_ms": wm,
            **profile_fields("sql", qname, rr["query"], torch),
            "joins": rr["joins"],
            "launches": {k: rr["launches"][k] for k in RIG_KERNELS}})
        log(f"  sql {qname}: times took {time.perf_counter() - t_query:.2f} s")
    log(json.dumps({"sql": sql_report}))
    seg_sum2_ab(torch)
    return sql_report


def run_decimal_queries(srt, K, torch, tpch, by_path, err) -> dict:
    """Phase 3k: phase 3i's 21 TPC-H SQL texts over the same tables with
    every money column as decimal(12,2), the views at 4 partitions under
    the default configuration; each held exactly against its decimal
    oracle, its hand-kernel calls replayed against the plain versions,
    seg_sum_f32 launched in q1 and murmur3_long in q18.  Returns each
    query's run (the query, cold seconds, launches, joins)."""
    phase("3k", f"the 21 TPC-H SQL queries over decimal(12,2) money "
        f"columns ({', '.join(c for cs in DEC_MONEY.values() for c in cs)}"
        f"; unscaled = round(x * 100)), TPC-H "
        f"({tpch['lineitem']['l_quantity'].size} lineitem rows, "
        f"seed {TPCH_SEED}), views at 4 partitions, default configuration")
    t0 = time.perf_counter()
    td = decimal_tpch_tables(tpch)
    dsess = srt.session()
    register_tpch_decimal_views(dsess, td)
    log(f"  decimal tables and views made in {time.perf_counter() - t0:.2f} s")
    must = {"tpch_q1_sql": ("seg_sum_f32",), "q18": ("murmur3_long",)}
    runs = {}
    for name, text, check in DEC_SQL_QUERIES:
        t_query = time.perf_counter()
        query = SqlQuery(dsess, text)
        q_seg: dict = {}
        q_mm: list = []
        with recording_seg_sums(K, q_seg), \
                recording(K, "murmur3_long", q_mm):
            got, launches, cold_s = drive(f"decimal {name}", query.collect,
                                          K, torch, must.get(name, ()),
                                          by_path)
        check_later(f"decimal {name}", check, got, td)
        for kname in SEG_SUM_BUILDS:
            if q_seg[kname]:
                err[kname] = max(err[kname], check_seg_sum_calls(
                    K, torch, kname, f"decimal {name}", q_seg[kname]))
        if q_mm:
            err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
                K, torch, f"decimal {name}", q_mm))
        del q_seg, q_mm
        joins = join_report(dsess.last_plan)
        types = [str(t) for t in got.types]
        log(f"  decimal {name}: {got.num_rows} rows (held exactly against "
            f"its decimal oracle in the background); types {types}; joins "
            f"{json.dumps(joins)}; "
            f"{time.perf_counter() - t_query:.2f} s")
        runs[name] = dict(query=query, cold_s=cold_s, launches=launches,
                          joins=joins, rows=got.num_rows)
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in RIG_KERNELS}
    log(f"  the decimal queries' launches of the hand kernels: {total}")
    return runs


def float_sql_warm(srt, torch, tpch) -> dict:
    """Phase 3i's queries over the float64 tables, each checked by its 3i
    oracle and timed warm (median of 3 after one warm-up): the float64
    column of phase 3k's table when phase 3i's own times are not run."""
    sess = srt.session()
    register_tpch_views(sess, tpch)
    out = {}
    for name, text, check, _ in SQL_QUERIES:
        query = SqlQuery(sess, text)
        check(query.collect(), tpch)
        torch.cuda.synchronize()
        out[name] = warm_ms(query, torch, SQL_WARM_RUNS)[0]
    return out


def decimal_times(dec_runs: dict, float_warm: dict, torch) -> list:
    """Phase 4's part for phase 3k: each decimal query cold, warm (median of
    3) and profiled once, beside the float64 form's warm ms from the same
    call; printed as the ``decimal`` JSON line."""
    log(f"  the 21 TPC-H SQL queries over decimal(12,2): cold, warm (median "
        f"of {SQL_WARM_RUNS}), a profile of one warm run of "
        f"{PROFILED['decimal']}, and the float64 tables' warm ms of this "
        "call")
    report = []
    for qname, rr in dec_runs.items():
        wm, tms = warm_ms(rr["query"], torch, SQL_WARM_RUNS)
        prof = profile_fields("decimal", qname, rr["query"], torch)
        fw = float_warm.get(qname)
        log(f"  decimal {qname}: cold {rr['cold_s'] * 1e3:.3f} ms; warm "
            f"median {wm:.3f} ms of {[round(t, 3) for t in tms]} ms; float64 "
            f"warm {fw:.3f} ms ({wm / fw:.2f}x)")
        report.append({
            "query": qname, "rows": rr["rows"],
            "cold_ms": rr["cold_s"] * 1e3, "warm_ms": wm,
            "float64_warm_ms": fw, **prof,
            "joins": rr["joins"],
            "launches": {k: rr["launches"][k] for k in RIG_KERNELS}})
    log(json.dumps({"decimal": report}))
    return report


def _words(rng, n: int):
    """(lo, hi) int64 words of n decimal(38,10) values: a third of 18
    digits or fewer, a third around +-2^63 and +-2^64, a third of up to
    38 digits (|hi| < 2^62, so below 2^126 < 10^38)."""
    lo = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                      dtype=np.int64)
    hi = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
    kind = rng.integers(0, 3, n)
    small = rng.integers(-10 ** 18 + 1, 10 ** 18, n, dtype=np.int64)
    lo = np.where(kind == 0, small, lo)
    hi = np.where(kind == 0, small >> 63, hi)
    near = rng.integers(-3, 3, n)                  # hi in -3..2: near 2^64
    hi = np.where(kind == 1, near, hi)
    big = 10 ** 38 - 1
    edge_vals = [0, -1, 1, big, -big, 1 << 63, -(1 << 63), 1 << 64,
                 -(1 << 64), (1 << 64) + 5, -(1 << 64) - 5]
    hit = np.nonzero(rng.random(n) < 0.02)[0]
    for i, j in zip(hit, rng.integers(0, len(edge_vals), hit.size)):
        u = edge_vals[j] & ((1 << 128) - 1)
        w_lo, w_hi = u & ((1 << 64) - 1), u >> 64
        lo[i] = w_lo - (1 << 64) if w_lo >= 1 << 63 else w_lo
        hi[i] = w_hi - (1 << 64) if w_hi >= 1 << 63 else w_hi
    return lo, hi


def make_decimal_matrix_data(rows: int, seed: int = SEED):
    """The decimal and arithmetic matrix's columns: u unique; k 100 keys;
    a decimal(12,2) and b decimal(18,4) at their +-(10^p - 1) edges; c and
    c2 decimal(38,10) of every size with +-2^63, +-2^64 and +-(10^38 - 1);
    i int, y byte, h short, x double; about 10% nulls each."""
    from spark_rapids_tpu_torch.columnar import HostDecimals
    from spark_rapids_tpu_torch import types as T
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(rows) < 0.1

    def bounded(precision):
        bound = 10 ** precision - 1
        v = rng.integers(-bound, bound + 1, rows, dtype=np.int64)
        hit = rng.random(rows) < 0.02
        v[hit] = np.array([bound, -bound, 0, 1, -1])[
            rng.integers(0, 5, int(hit.sum()))]
        return np.ma.MaskedArray(v, mask=nulls())

    def wide():
        lo, hi = _words(rng, rows)
        valid = ~nulls()
        return HostDecimals(np.where(valid, lo, 0), np.where(valid, hi, 0),
                            valid, T.DecimalType(38, 10))
    return {
        "u": np.arange(rows, dtype=np.int64),
        "k": rng.integers(0, 100, rows).astype(np.int32),
        "a": HostDecimals.from_unscaled(bounded(12), 12, 2),
        "b": HostDecimals.from_unscaled(bounded(18), 18, 4),
        "c": wide(), "c2": wide(),
        "i": np.ma.MaskedArray(rng.integers(-10 ** 6, 10 ** 6, rows).astype(
            np.int32), mask=nulls()),
        "y": rng.integers(-128, 128, rows).astype(np.int8),
        "h": rng.integers(-32768, 32768, rows).astype(np.int16),
        "x": np.ma.MaskedArray(np.round(rng.normal(0, 1e4, rows), 3),
                               mask=nulls())}


#: the decimal matrix's statements over view ``m`` (and ``dim``, 1,000
#: decimal(12,2) keys)
DECIMAL_MATRIX = {
    "arithmetic": "SELECT u, a + b AS s1, c - c2 AS s2, c + a AS s3, "
                  "a * b AS m1, c * a AS m2, c * c2 AS m3, a / b AS d1, "
                  "c / a AS d2, c / c2 AS d3, a % b AS r1, c % a AS r2, "
                  "pmod(c, b) AS r3, a DIV b AS q1, c DIV c2 AS q2, "
                  "-c AS n1, abs(c) AS n2, least(a, b) AS l1, "
                  "greatest(c, c2) AS g1, i & k AS b1, i | k AS b2, "
                  "i ^ k AS b3, ~i AS b4, i << 3 AS b5, i >> 63 AS b6, "
                  "i >>> k AS b7, y + h AS b8, y DIV 7 AS b9 FROM m",
    "casts": "SELECT u, CAST(a AS decimal(20,4)) AS c1, "
             "CAST(b AS decimal(12,2)) AS c2, CAST(c AS decimal(18,4)) AS c3, "
             "CAST(c AS decimal(38,2)) AS c4, CAST(b AS int) AS c5, "
             "CAST(c AS bigint) AS c6, CAST(a AS double) AS c7, "
             "CAST(c AS double) AS c8, CAST(x AS decimal(12,2)) AS c9, "
             "CAST(x AS decimal(38,10)) AS c10, CAST(i AS decimal(12,2)) "
             "AS c11, CAST(a AS tinyint) AS c12, CAST(x AS smallint) AS c13, "
             "CAST(c AS boolean) AS c14, floor(c) AS c15, ceil(a) AS c16, "
             "round(c, 3) AS c17, bround(b, 1) AS c18, c > c2 AS p1, "
             "a = b AS p2, c IN (0, 1) AS p3, "
             "CASE WHEN i > 0 THEN a WHEN i < -10 THEN c ELSE b END AS w1, "
             "coalesce(c, a) AS w2, hash(a, c) AS h1, xxhash64(c, b) AS h2 "
             "FROM m",
    "aggregates": "SELECT k, sum(a) AS sa, sum(b) AS sb, sum(c) AS sc, "
                  "avg(a) AS va, avg(b) AS vb, avg(c) AS vc, min(c) AS nc, "
                  "max(c) AS xc, min(b) AS nb, max(a) AS xa, count(c) AS n "
                  "FROM m GROUP BY k",
    "group_by_decimal": "SELECT c, count(*) AS n, sum(a) AS s FROM m "
                        "WHERE abs(c) < 1000000 OR c IS NULL GROUP BY c",
    "sort_by_decimal": "SELECT u, c FROM m ORDER BY c DESC, u LIMIT 5000",
    "join_on_decimal": "SELECT m.u, dim.v FROM m JOIN dim ON m.a = dim.a",
}


def collect_words(sess, text: str) -> dict:
    """A statement's result as numpy arrays, without the host's decimal
    objects (a million rows of them take seconds to make): per column the
    live rows' data (a decimal's low word), a decimal's high word (None
    for other types) and validity, nulls zeroed."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import dec_words
    plan = sess.physical_plan(sess.sql(text))
    batch = ColumnarBatch.concat(plan.execute_all())
    n = batch.num_rows_int
    out = {}
    for name, c in zip(batch.names, batch.columns):
        valid = c.validity[:n].cpu().numpy()
        words = dec_words(c) if isinstance(c.dtype, T.DecimalType) \
            else (c.data, None)
        out[name] = []
        for w in words:
            if w is not None:
                w = w[:n].cpu().numpy()
                w = np.where(valid, w, np.zeros((), w.dtype))
            out[name].append(w)
        out[name].append(valid)
    return out


def check_same_words(a: dict, b: dict, label: str) -> None:
    """Two ``collect_words`` results of one statement, rows in a canonical
    order (sorted by every column), equal: validity and words exact, NaN
    equal to NaN."""
    if list(a) != list(b):
        raise AssertionError(f"{label}: columns {list(a)} vs {list(b)}")

    def ordered(res):
        keys = [arr for col in res.values() for arr in col
                if arr is not None]
        perm = np.lexsort(keys[::-1])
        return {k: [None if x is None else x[perm] for x in v]
                for k, v in res.items()}
    a, b = ordered(a), ordered(b)
    for name in a:
        for x, y in zip(a[name], b[name]):
            if (x is None) != (y is None) or (x is not None and (
                    x.shape != y.shape or not np.array_equal(
                        x, y, equal_nan=np.issubdtype(x.dtype,
                                                      np.floating)))):
                raise AssertionError(f"{label}: {name} differs")


def decimal_matrix(srt, torch) -> None:
    """Phase 3k's matrix: DECIMAL_MATRIX over DECIMAL_MATRIX_ROWS rows at 4
    partitions, hash exchanges that never coalesce (minRows 0) and a
    shuffled join, run on cuda and on the cpu (in the background,
    ``cpu_side``): every column equal."""
    log(f"  the decimal and arithmetic matrix: {DECIMAL_MATRIX_ROWS} rows at "
        "4 partitions, every operator of arithmetic.py, the decimal casts, "
        "sum/avg/min/max and a decimal key through group, sort, join and the "
        "hash exchange, on cuda and on the cpu")
    data = make_decimal_matrix_data(DECIMAL_MATRIX_ROWS)
    keys = data["a"][:1000]
    dim = {"a": keys, "v": np.arange(len(keys), dtype=np.int64)}
    conf = {"spark.sql.adaptive.coalescePartitions.minRows": 0,
            "spark.rapids.sql.autoBroadcastJoinThreshold": 1}

    def decimal_side(dev):
        sm = srt.session(device=dev, conf=conf)
        sm.create_dataframe(data, num_partitions=4).createOrReplaceTempView(
            "m")
        sm.create_dataframe(dim, num_partitions=2).createOrReplaceTempView(
            "dim")
        got = {}
        for name, text in DECIMAL_MATRIX.items():
            t0 = time.perf_counter()
            got[name] = collect_words(sm, text)
            rows = next(iter(got[name].values()))[-1].size
            log(f"    {dev} {name}: {time.perf_counter() - t0:.3f} s, "
                f"{rows} rows")
            if not rows:
                raise AssertionError(f"decimal matrix {name}: no rows")
        return got
    on_card = decimal_side("cuda")

    def decimal_check(on_cpu):
        for name in DECIMAL_MATRIX:
            check_same_words(on_card[name], on_cpu[name],
                             f"decimal matrix {name}")
        log("  the decimal matrix agrees on cuda and the cpu: every column "
            "exact")
    cpu_side("decimal", lambda: decimal_side("cpu"), decimal_check)


# ---------------------------------------------------------------------------
# Phase 3l: a month of NYC yellow-taxi trips, parsed from text
# ---------------------------------------------------------------------------

#: about one month of 2019 yellow trips (January 2019: 7.7M)
TLC_ROWS = 8_000_000
TLC_SEED = 2019
TLC_MATRIX_ROWS = MATRIX_ROWS
#: 2019-01-01 00:00:00 UTC in microseconds
TLC_JAN_2019_US = 1_546_300_800 * 1_000_000
#: the 18 columns of the TLC's 2019 yellow trip CSV files, in order, as the
#: TLC's Yellow Taxi Trip Records data dictionary defines them
TLC_COLUMNS = ("VendorID", "tpep_pickup_datetime", "tpep_dropoff_datetime",
               "passenger_count", "trip_distance", "RatecodeID",
               "store_and_fwd_flag", "PULocationID", "DOLocationID",
               "payment_type", "fare_amount", "extra", "mta_tax",
               "tip_amount", "tolls_amount", "improvement_surcharge",
               "total_amount", "congestion_surcharge")
TLC_MONEY = ("fare_amount", "extra", "mta_tax", "tip_amount", "tolls_amount",
             "improvement_surcharge", "total_amount", "congestion_surcharge")
TLC_ZONES = 265
#: pickups by hour of day, New York's shape: a trough at 4-5 am, a peak at
#: 6-7 pm
TLC_HOUR_WEIGHTS = (2.7, 1.9, 1.4, 1.0, 0.8, 1.0, 2.2, 3.6, 4.4, 4.5, 4.3,
                    4.4, 4.7, 4.7, 5.0, 5.2, 5.3, 5.9, 6.5, 6.4, 5.9, 5.6,
                    5.1, 3.9)
#: malformed timestamp texts: each 19 characters and null under both parses
TLC_BAD_TIMESTAMPS = ("2019-02-30 10:00:00", "2019-01-15 24:10:00",
                      "2019-01-15 10:61:00", "2019-13-01 00:00:00")
TLC_BAD_SHARE = 1e-4
TLC_DUP_SHARE = 1e-3
TLC_BLANK_PASSENGERS = 0.01
TLC_REFUND_SHARE = 1e-3

TLC_VIEW = """CREATE OR REPLACE TEMPORARY VIEW trips AS SELECT
  CAST(VendorID AS INT) vendor,
  to_timestamp(tpep_pickup_datetime, 'yyyy-MM-dd HH:mm:ss') pickup,
  CAST(tpep_dropoff_datetime AS TIMESTAMP) dropoff,
  CAST(passenger_count AS INT) passengers,
  CAST(trip_distance AS DOUBLE) dist,
  CAST(RatecodeID AS INT) ratecode,
  upper(trim(store_and_fwd_flag)) flag,
  CAST(PULocationID AS INT) pu_zone,
  CAST(DOLocationID AS INT) do_zone,
  CAST(payment_type AS INT) payment,
  CAST(fare_amount AS DECIMAL(10,2)) fare,
  CAST(extra AS DECIMAL(10,2)) extra,
  CAST(mta_tax AS DECIMAL(10,2)) mta_tax,
  CAST(tip_amount AS DECIMAL(10,2)) tip,
  CAST(tolls_amount AS DECIMAL(10,2)) tolls,
  CAST(improvement_surcharge AS DECIMAL(10,2)) improvement,
  CAST(total_amount AS DECIMAL(10,2)) total,
  CAST(congestion_surcharge AS DECIMAL(10,2)) congestion
FROM trips_raw"""

TLC_QUERIES = {
    "tlc_hourly": """SELECT hour(pickup) h, count(*) trips,
        avg(dist) avg_dist, sum(total) revenue
      FROM trips GROUP BY hour(pickup) ORDER BY h""",
    "tlc_hour_series": """SELECT to_timestamp(date_format(pickup,
        'yyyy-MM-dd HH'), 'yyyy-MM-dd HH') hr, count(*) trips,
        sum(total) revenue
      FROM trips GROUP BY 1 ORDER BY 1""",
    "tlc_duplicates": """SELECT count(*) dup_groups, sum(c) dup_trips FROM (
        SELECT pickup, dropoff, pu_zone, count(*) c FROM trips
        GROUP BY pickup, dropoff, pu_zone HAVING count(*) > 1) d""",
    "tlc_daily_duration": """SELECT date_format(pickup, 'yyyy-MM-dd') day,
        payment, count(*) trips,
        avg(unix_timestamp(dropoff) - unix_timestamp(pickup)) avg_secs,
        sum(tip) tips
      FROM trips GROUP BY 1, 2 ORDER BY 1, 2""",
    "tlc_routes": """SELECT concat_ws('-', lpad(CAST(pu_zone AS STRING), 3,
        '0'), lpad(CAST(do_zone AS STRING), 3, '0')) route, count(*) trips,
        sum(total) revenue
      FROM trips GROUP BY 1 ORDER BY trips DESC, route LIMIT 20""",
    "tlc_zone_7day": """SELECT pu_zone, day, revenue,
        sum(revenue) OVER (PARTITION BY pu_zone ORDER BY day
          ROWS BETWEEN 6 PRECEDING AND CURRENT ROW) rev_7d,
        avg(revenue) OVER (PARTITION BY pu_zone ORDER BY day
          ROWS BETWEEN 6 PRECEDING AND CURRENT ROW) avg_7d
      FROM (SELECT pu_zone, CAST(pickup AS DATE) day, sum(total) revenue
            FROM trips WHERE pickup IS NOT NULL
            GROUP BY pu_zone, CAST(pickup AS DATE)) z
      ORDER BY pu_zone, day""",
    "tlc_export": """SELECT count(*) n, sum(length(line)) chars,
        min(line) first_line, max(line) last_line FROM (
        SELECT concat_ws(',', CAST(vendor AS STRING), CAST(pickup AS STRING),
          date_format(dropoff, 'yyyy-MM-dd HH:mm:ss'), CAST(fare AS STRING),
          CAST(total AS STRING), flag) line FROM trips) e""",
}


_P10 = np.array([10 ** k for k in range(19)], dtype=np.int64)


def _text_digits(v):
    """(uint8[n, w] digits, int32 lengths) of non-negative int64 values."""
    v = np.asarray(v, dtype=np.int64)
    nd = np.ones(v.shape, dtype=np.int64)
    for k in range(1, 19):
        nd += v >= _P10[k]
    w = int(nd.max()) if v.size else 1
    mat = np.zeros((v.size, w), dtype=np.uint8)
    for j in range(w):
        place = nd - 1 - j
        d = (v // _P10[np.clip(place, 0, 18)]) % 10 + 48
        mat[:, j] = np.where(place >= 0, d, 0)
    return mat, nd.astype(np.int32)


def _text_money(cents):
    """'d.dd' text of int64 cents (a minus sign before a negative): each
    distinct value of the range made once, position by position, then
    gathered."""
    cents = np.asarray(cents, dtype=np.int64)
    lo = int(cents.min()) if cents.size else 0
    span = np.arange(lo, (int(cents.max()) if cents.size else 0) + 1)
    neg = (span < 0).astype(np.int64)
    a = np.abs(span)
    ip = a // 100
    nd = np.ones(a.shape, dtype=np.int64)
    for k in range(1, 19):
        nd += ip >= _P10[k]
    total = neg + nd + 3
    w = int(total.max())
    mat = np.zeros((a.size, w), dtype=np.uint8)
    for j in range(w):
        k = j - neg                       # index past the sign
        place = nd - 1 - k
        digit = (ip // _P10[np.clip(place, 0, 18)]) % 10 + 48
        frac = np.where(k == nd + 1, (a // 10) % 10, a % 10) + 48
        ch = np.where(k < nd, digit, np.where(k == nd, 46, frac))
        ch = np.where(k < 0, 45, ch)
        mat[:, j] = np.where(j < total, ch, 0)
    idx = cents - lo
    return mat[idx], total.astype(np.int32)[idx]


def _civil_text(secs):
    """'yyyy-MM-dd HH:mm:ss' of whole seconds, from civil fields in int64
    arithmetic (years 1-9999)."""
    days, tod = np.divmod(secs, 86_400)
    z = days + 719_468                       # Howard Hinnant's civil date
    era = z // 146_097
    doe = z - era * 146_097
    yoe = (doe - doe // 1460 + doe // 36_524 - doe // 146_096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    day = doy - (153 * mp + 2) // 5 + 1
    month = np.where(mp < 10, mp + 3, mp - 9)
    year = yoe + era * 400 + (month <= 2)
    fields = ((year, 4), (month, 2), (day, 2), (tod // 3600, 2),
              (tod // 60 % 60, 2), (tod % 60, 2))
    mat = np.empty((secs.size, 19), dtype=np.uint8)
    at = 0
    for (v, width), sep in zip(fields, b"-- ::\0"):
        for j in range(width):
            mat[:, at + j] = v // _P10[width - 1 - j] % 10 + 48
        at += width
        if at < 19:
            mat[:, at] = sep
            at += 1
    return mat


def _text_timestamps(micros):
    """'yyyy-MM-dd HH:mm:ss' of micros (Java's form of a timestamp of
    whole seconds): each day's date text and each second of the day's
    time text made once, then gathered."""
    secs = np.asarray(micros, dtype=np.int64) // 1_000_000
    days, tod = np.divmod(secs, 86_400)
    d0 = int(days.min()) if secs.size else 0
    span = np.arange(d0, (int(days.max()) if secs.size else 0) + 1)
    dates = _civil_text(span * 86_400)[:, :11]
    times = _civil_text(np.arange(86_400))[:, 11:]
    mat = np.concatenate([dates[days - d0], times[tod]], axis=1)
    return mat, np.full(secs.size, 19, dtype=np.int32)


def _text_const(values, n: int, idx):
    """A column of the texts ``values[idx]``."""
    enc = [v.encode() for v in values]
    w = max(len(b) for b in enc) or 1
    table = np.zeros((len(enc), w), dtype=np.uint8)
    for i, b in enumerate(enc):
        table[i, :len(b)] = list(b)
    lens = np.array([len(b) for b in enc], dtype=np.int32)
    return table[idx], lens[idx]


def make_tlc_trips(rows: int, seed: int = TLC_SEED):
    """A month of yellow-taxi trips in the TLC's 2019 CSV schema, every
    column text, from ``seed`` with numpy (the text built as byte
    matrices, no per-row Python).  Returns (raw, truth): raw maps each of
    TLC_COLUMNS to (uint8 matrix, int32 lengths, valid); truth holds the
    integers the text was made from (micros, cents, ids) with the masks of
    the malformed and blank fields.

    Distributions: pickups over January 2019, days weighted by weekday
    (weekends 0.85, Tuesday-Friday 1.05, New Year's Day 0.8), hours by
    TLC_HOUR_WEIGHTS, minutes and seconds uniform; durations lognormal
    (median 11 minutes, sigma 0.75, 1 s to 3 h); distance from the
    duration at a lognormal speed (median 11 mph, sigma 0.35); zones 1-265
    drawn with a Zipf-like skew over a seeded order of the zones
    (exponent 1.1 for pickups, 0.9 for drop-offs: pickups crowd into a few
    Manhattan zones); vendor 2 58%; passengers 1-6 (1: 71%), 0.5% "0",
    1% blank (null); rate code 1 97%; flag "N" 99%, "Y" 0.7%, 0.3%
    padded lower case (" n", "y "); payment 1 card 71%, 2 cash 27.5%, 3
    and 4 the rest; fare 2.50 + 2.50 a mile + 0.50 a minute, extra by
    hour, mta 0.50, card tips 10-30% of the fare, tolls 5.76 on 5%,
    improvement 0.30, congestion 2.50 on 80%, total their sum; 0.1%
    refunds (every amount negative); 0.01% malformed pickup and drop-off
    texts (TLC_BAD_TIMESTAMPS); 0.1% exact duplicate trips, as the TLC's
    files hold some."""
    rng = np.random.default_rng(seed)
    n = rows
    dow = (np.arange(31) + 1) % 7          # 2019-01-01 is a Tuesday: 1
    day_w = np.where((dow == 5) | (dow == 6), 0.85, 1.05)
    day_w[0] = 0.8
    day = rng.choice(31, n, p=day_w / day_w.sum())
    hw = np.array(TLC_HOUR_WEIGHTS)
    hour = rng.choice(24, n, p=hw / hw.sum())
    secs = day * 86400 + hour * 3600 + rng.integers(0, 3600, n)
    pickup = TLC_JAN_2019_US + secs.astype(np.int64) * 1_000_000
    dur = np.clip(np.round(rng.lognormal(np.log(660), 0.75, n)), 1,
                  10_800).astype(np.int64)
    dropoff = pickup + dur * 1_000_000
    speed = rng.lognormal(np.log(11.0), 0.35, n)
    dist = np.clip(np.round(dur / 3600 * speed * 100), 0, 99_999).astype(
        np.int64)
    order = rng.permutation(TLC_ZONES) + 1

    def zones(s):
        w = 1.0 / (np.arange(TLC_ZONES) + 5.0) ** s
        return order[rng.choice(TLC_ZONES, n, p=w / w.sum())]
    pu, do = zones(1.1), zones(0.9)
    vendor = np.where(rng.random(n) < 0.58, 2, 1)
    pass_idx = rng.choice(7, n, p=[0.005, 0.705, 0.15, 0.04, 0.02, 0.05,
                                   0.03])
    pass_ok = rng.random(n) >= TLC_BLANK_PASSENGERS
    rate = rng.choice(np.array([1, 2, 3, 4, 5, 99]), n,
                      p=[0.97, 0.02, 0.0015, 0.0015, 0.0069, 0.0001])
    flag_idx = rng.choice(4, n, p=[0.99, 0.007, 0.0015, 0.0015])
    payment = rng.choice(np.array([1, 2, 3, 4]), n,
                         p=[0.71, 0.275, 0.01, 0.005])
    fare = 250 + np.round(dist * 2.5).astype(np.int64) + (dur // 60) * 50
    extra = np.where((hour >= 20) | (hour < 6), 50,
                     np.where((hour >= 16) & (hour < 20), 100, 0))
    extra = np.where(rng.random(n) < 0.01, 250, extra).astype(np.int64)
    mta = np.full(n, 50, dtype=np.int64)
    tip = np.where(payment == 1, np.round(fare * rng.uniform(0.1, 0.3, n)),
                   0).astype(np.int64)
    tolls = np.where(rng.random(n) < 0.05, 576, 0).astype(np.int64)
    improvement = np.full(n, 30, dtype=np.int64)
    congestion = np.where(rng.random(n) < 0.8, 250, 0).astype(np.int64)
    refund = rng.random(n) < TLC_REFUND_SHARE
    sign = np.where(refund, -1, 1)
    money = {"fare_amount": fare * sign, "extra": extra * sign,
             "mta_tax": mta * sign, "tip_amount": tip * sign,
             "tolls_amount": tolls * sign,
             "improvement_surcharge": improvement * sign,
             "congestion_surcharge": congestion * sign}
    money["total_amount"] = sum(money[k] for k in TLC_MONEY
                                if k != "total_amount")
    payment = np.where(refund, rng.choice(np.array([3, 4]), n), payment)
    pickup_ok = rng.random(n) >= TLC_BAD_SHARE
    dropoff_ok = rng.random(n) >= TLC_BAD_SHARE
    bad_pick = rng.integers(0, len(TLC_BAD_TIMESTAMPS), n)
    bad_drop = rng.integers(0, len(TLC_BAD_TIMESTAMPS), n)
    truth = dict(vendor=vendor, pickup=pickup, pickup_ok=pickup_ok,
                 dropoff=dropoff, dropoff_ok=dropoff_ok,
                 passengers=pass_idx, passengers_ok=pass_ok, dist=dist,
                 rate=rate, flag_idx=flag_idx, pu=pu, do=do,
                 payment=payment, bad_pick=bad_pick, bad_drop=bad_drop,
                 **money)
    # exact duplicates: every field of an earlier trip
    dup = np.flatnonzero(rng.random(n) < TLC_DUP_SHARE)
    dup = dup[dup > 0]
    src = (rng.random(dup.size) * dup).astype(np.int64)
    for k, v in truth.items():
        v[dup] = v[src]
    truth["flag"] = np.array([78, 89, 78, 89], dtype=np.uint8)[
        truth["flag_idx"]]
    raw = {}
    raw["VendorID"] = _text_digits(truth["vendor"]) + (np.ones(n, bool),)

    def stamps(micros, ok, bad):
        mat, lens = _text_timestamps(micros)
        bmat, _ = _text_const(TLC_BAD_TIMESTAMPS, n, bad)
        return np.where(ok[:, None], mat, bmat), lens, np.ones(n, bool)
    raw["tpep_pickup_datetime"] = stamps(truth["pickup"], truth["pickup_ok"],
                                         truth["bad_pick"])
    raw["tpep_dropoff_datetime"] = stamps(
        truth["dropoff"], truth["dropoff_ok"], truth["bad_drop"])
    pm, pl = _text_digits(truth["passengers"])
    raw["passenger_count"] = (pm, np.where(truth["passengers_ok"], pl, 0),
                              truth["passengers_ok"])
    raw["trip_distance"] = _text_money(truth["dist"]) + (np.ones(n, bool),)
    raw["RatecodeID"] = _text_digits(truth["rate"]) + (np.ones(n, bool),)
    raw["store_and_fwd_flag"] = _text_const(
        ["N", "Y", " n", "y "], n, truth["flag_idx"]) + (np.ones(n, bool),)
    raw["PULocationID"] = _text_digits(truth["pu"]) + (np.ones(n, bool),)
    raw["DOLocationID"] = _text_digits(truth["do"]) + (np.ones(n, bool),)
    raw["payment_type"] = _text_digits(truth["payment"]) + (
        np.ones(n, bool),)
    for k in TLC_MONEY:
        raw[k] = _text_money(truth[k]) + (np.ones(n, bool),)
    return {k: raw[k] for k in TLC_COLUMNS}, truth


def tlc_host_strings(raw):
    """The raw text columns as the port's host string columns
    (``HostStrings``: Arrow's offsets and bytes), for create_dataframe."""
    from spark_rapids_tpu_torch.columnar.convert import HostStrings
    out = {}
    for name, (mat, lens, valid) in raw.items():
        lens = np.where(valid, lens, 0).astype(np.int64)
        offsets = np.zeros(lens.size + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        if lens.size and lens.min() == lens.max():    # one width: no mask
            data = np.ascontiguousarray(mat[:, :lens[0]]).reshape(-1)
        else:
            data = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]
        out[name] = HostStrings(offsets, data, valid.copy())
    return out


def _packed_groups(keys):
    """(distinct key rows in ascending order, each row's group, group
    count) of int64 key columns (a null as -1, so first): the keys packed
    into one code by their ranges and grouped by a bincount, O(rows), or
    by one sort where the packed range is wide."""
    n = len(keys[0])
    code = np.zeros(n, dtype=np.int64)
    spans = []
    size = 1
    for k in keys:
        lo = int(k.min()) if n else 0
        span = (int(k.max()) - lo + 1) if n else 1
        if size * span >= 1 << 62:
            raise AssertionError("_packed_groups: keys too wide to pack")
        code = code * span + (k - lo)
        spans.append((lo, span))
        size *= span
    if size <= 1 << 26:
        counts = np.bincount(code, minlength=size)
        present = np.flatnonzero(counts)
        gid = np.zeros(size, dtype=np.int64)
        gid[present] = np.arange(present.size)
        inv = gid[code]
    else:
        present, inv = np.unique(code, return_inverse=True)
    out = []
    rest = present.astype(np.int64)
    for lo, span in reversed(spans):
        out.append(rest % span + lo)
        rest = rest // span
    return out[::-1], inv.ravel(), present.size


def tlc_oracles(t):
    """Each TLC query's expected rows, from the generator's integers
    (groups by packed keys and bincounts; timestamps are whole seconds)."""
    exp = {}
    pok, dok = t["pickup_ok"], t["dropoff_ok"]
    total = t["total_amount"]
    psec, dsec = t["pickup"] // 1_000_000, t["dropoff"] // 1_000_000
    if np.any(t["pickup"] % 1_000_000) or np.any(t["dropoff"] % 1_000_000):
        raise AssertionError("tlc_oracles: timestamps of whole seconds")
    # hourly: null pickups are one group, first
    (g,), inv, ng = _packed_groups([np.where(pok, psec // 3600 % 24, -1)])
    cnt = np.bincount(inv, minlength=ng)
    exp["tlc_hourly"] = dict(
        h=[None if x < 0 else int(x) for x in g], trips=cnt.tolist(),
        avg_dist=(np.bincount(inv, weights=t["dist"] / 100.0,
                              minlength=ng) / cnt),
        revenue=_sum_exact(inv, total, ng).tolist())
    # hour series
    (g,), inv, ng = _packed_groups([np.where(pok, psec // 3600, -1)])
    exp["tlc_hour_series"] = dict(
        hr=[None if x < 0 else int(x) * 3_600_000_000 for x in g],
        trips=np.bincount(inv, minlength=ng).tolist(),
        revenue=_sum_exact(inv, total, ng).tolist())
    # duplicates over (pickup, dropoff, pu) with nulls equal
    base = int(psec[pok].min()) if pok.any() else 0
    _, inv, ng = _packed_groups([np.where(pok, psec - base, -1),
                                 np.where(dok, dsec - base, -1), t["pu"]])
    c = np.bincount(inv, minlength=ng)
    exp["tlc_duplicates"] = dict(dup_groups=[int((c > 1).sum())],
                                 dup_trips=[int(c[c > 1].sum())])
    # daily duration by (day text, payment)
    (gday, gpay), inv, ng = _packed_groups(
        [np.where(pok, psec // 86_400, -1), t["payment"]])
    both = pok & dok
    dcnt = np.bincount(inv, weights=both, minlength=ng)
    dsum = np.bincount(inv, weights=np.where(both, dsec - psec, 0),
                       minlength=ng)
    exp["tlc_daily_duration"] = dict(
        day=[None if d < 0 else str(np.datetime64(int(d), "D"))
             for d in gday],
        payment=gpay.tolist(),
        trips=np.bincount(inv, minlength=ng).tolist(),
        avg_secs=np.where(dcnt > 0, dsum / np.maximum(dcnt, 1), np.nan),
        tips=_sum_exact(inv, t["tip_amount"], ng).tolist())
    # routes: top 20 by trips, then route text
    (gpu, gdo), inv, ng = _packed_groups([t["pu"], t["do"]])
    cnt = np.bincount(inv, minlength=ng)
    rev = _sum_exact(inv, total, ng)
    top = np.lexsort((gpu * 1000 + gdo, -cnt))[:20]
    exp["tlc_routes"] = dict(
        route=[f"{a:03d}-{b:03d}" for a, b in zip(gpu[top], gdo[top])],
        trips=cnt[top].tolist(), revenue=[rev[i] for i in top])
    # daily revenue per zone, then its 7-row sum and HALF_UP average
    (zs, ds), inv, ng = _packed_groups([t["pu"][pok], psec[pok] // 86_400])
    rev = _sum_exact(inv, total[pok], ng)
    rev7, avg7 = [], []
    for i in range(ng):
        lo = i
        while lo > 0 and i - lo < 6 and zs[lo - 1] == zs[i]:
            lo -= 1
        s = sum(rev[lo:i + 1])
        rev7.append(s)
        avg7.append(_half_up(s * 10 ** 4, i + 1 - lo))
    exp["tlc_zone_7day"] = dict(
        pu_zone=zs.tolist(), day=[str(np.datetime64(int(d), "D"))
                                  for d in ds],
        revenue=list(rev), rev_7d=rev7, avg_7d=avg7)
    # export lines: their count, characters, least and greatest
    pieces = tlc_export_pieces(t)
    present = np.stack([ok for _, _, ok in pieces], axis=1)
    lens = sum(np.where(ok, ln, 0) for _, ln, ok in pieces) + \
        present.sum(axis=1) - 1
    first, last = (_export_extreme(pieces, present, b) for b in (False,
                                                                 True))
    exp["tlc_export"] = dict(
        n=[int(lens.size)], chars=[int(lens.sum())],
        first_line=[_export_line(pieces, first)],
        last_line=[_export_line(pieces, last)])
    return exp


def tlc_export_pieces(t):
    """tlc_export's pieces per row: (text matrix, lengths, present) of
    vendor, pickup, drop-off, fare, total and flag (a null piece is
    skipped, as concat_ws skips it)."""
    n = t["vendor"].size
    one = np.ones(n, dtype=bool)
    return [_text_digits(t["vendor"]) + (one,),
            _text_timestamps(t["pickup"]) + (t["pickup_ok"],),
            _text_timestamps(t["dropoff"]) + (t["dropoff_ok"],),
            _text_money(t["fare_amount"]) + (one,),
            _text_money(t["total_amount"]) + (one,),
            (t["flag"][:, None], np.ones(n, dtype=np.int32), one)]


def _export_line(pieces, row: int) -> str:
    return ",".join(bytes(m[row, :ln[row]]).decode()
                    for m, ln, ok in pieces if ok[row])


def _export_extreme(pieces, present, biggest: bool) -> int:
    """The row whose line is least (greatest) in byte order, without
    building the lines: a line is its present pieces joined by ','
    (below every byte a piece holds), so lines order as the tuples of
    their pieces, a piece that is a prefix of another first.  The
    candidates narrow piece by piece."""
    cand = np.arange(present.shape[0])
    rank = np.cumsum(present, axis=1) - 1       # ordinal of each piece
    width = max(m.shape[1] for m, _, _ in pieces)
    for p in range(len(pieces)):
        key = np.zeros((cand.size, width), dtype=np.uint8)
        has = np.zeros(cand.size, dtype=np.uint64)
        for i, (m, ln, ok) in enumerate(pieces):
            sel = ok[cand] & (rank[cand, i] == p)
            rows = cand[sel]
            pos = np.arange(m.shape[1])[None, :] < ln[rows][:, None]
            key[sel, :m.shape[1]] = np.where(pos, m[rows], 0)
            has[sel] = 1
        words = [has] + tlc_line_words(key)
        cand = cand[_lex_extreme_all(words, biggest)]
        if cand.size == 1:
            break
    return int(cand[0])


def tlc_line_words(lines):
    """Big-endian uint64 words of a zero-padded byte matrix, most
    significant first: their lexicographic order is the lines' byte
    order."""
    w = -(-lines.shape[1] // 8) * 8
    pad = np.zeros((lines.shape[0], w), dtype=np.uint8)
    pad[:, :lines.shape[1]] = lines
    words = pad.view(">u8").astype(np.uint64)
    return [words[:, i] for i in range(words.shape[1])]


def _lex_extreme_all(words, biggest: bool) -> np.ndarray:
    """The rows whose words are lexicographically least (or greatest), all
    of them: the candidates narrowed word by word, O(rows) a word."""
    cand = np.arange(words[0].size)
    for w in words:
        v = w[cand]
        cand = cand[v == (v.max() if biggest else v.min())]
    return cand


def _tlc_ts(got, name):
    vals, nulls = _col(got, name)
    return [None if m else int(np.datetime64(v, "us").astype(np.int64))
            for v, m in zip(vals, nulls)]


def tlc_check(name: str, got, exp) -> None:
    """One TLC query's rows against its oracle: keys, counts, texts and
    decimals (as unscaled ints) exact, doubles within RTOL_F64."""
    e = exp[name]
    if list(got.column_names) != list(e):
        raise AssertionError(f"{name}: columns {got.column_names}, want "
                             f"{list(e)}")
    n = len(next(iter(e.values())))
    if got.num_rows != n:
        raise AssertionError(f"{name}: {got.num_rows} rows, want {n}")
    scales = {"revenue": 2, "tips": 2, "rev_7d": 2, "avg_7d": 6}
    for c, want in e.items():
        if c in scales:
            g = _unscaled(got, c, scales[c])
            w = [int(x) for x in want]
        elif c in ("avg_dist", "avg_secs"):
            vals, nulls = _col(got, c)
            w = np.asarray(want, dtype=np.float64)
            if not np.array_equal(nulls, np.isnan(w)):
                raise AssertionError(f"{name}: nulls of {c} differ")
            np.testing.assert_allclose(vals[~nulls], w[~nulls],
                                       rtol=RTOL_F64, err_msg=f"{name} {c}")
            continue
        elif c == "hr":
            g, w = _tlc_ts(got, c), list(want)
        elif c == "day":
            vals, nulls = _col(got, c)
            g = [None if m else str(v) for v, m in zip(vals, nulls)]
            w = list(want)
        else:
            vals, nulls = _col(got, c)
            g = [None if m else (v.item() if isinstance(v, np.generic)
                                 else v) for v, m in zip(vals, nulls)]
            w = [x.item() if isinstance(x, np.generic) else x for x in want]
        if g != w:
            bad = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
            raise AssertionError(f"{name}: column {c} differs at row {bad}: "
                                 f"{g[bad]!r} vs {w[bad]!r}")


def register_tlc_views(sess, raw, parts: int = 4) -> None:
    sess.create_dataframe(tlc_host_strings(raw), num_partitions=parts
                          ).createOrReplaceTempView("trips_raw")
    sess.sql(TLC_VIEW)


def run_tlc_queries(srt, K, torch, raw, truth, by_path, err) -> dict:
    """Phase 3l: the typed view over the raw text at 4 partitions, default
    configuration, and the seven queries, each exact against its numpy
    oracle on its first call, its hand-kernel calls replayed against the
    plain versions, seg_sum_f32 and seg_sum_f64 launched in tlc_hourly and
    murmur3_long in tlc_duplicates.  The oracles are computed in a thread
    while the text uploads and the first query runs.  Returns each query's
    run."""
    n = truth["vendor"].size
    phase("3l", f"a month of NYC yellow-taxi trips parsed from text "
        f"({n} rows, seed {TLC_SEED}, the 18 columns of the TLC's 2019 "
        f"yellow CSV as strings), the typed view at 4 partitions, default "
        f"configuration")
    with ThreadPoolExecutor(1) as pool:
        oracles = pool.submit(tlc_oracles, truth)
        return _tlc_runs(srt, K, torch, raw, oracles, by_path, err)


def _tlc_runs(srt, K, torch, raw, oracles, by_path, err) -> dict:
    n = len(raw["VendorID"][1])
    t0 = time.perf_counter()
    sess = srt.session()
    register_tlc_views(sess, raw)
    # each column a byte matrix of its widest text's bucket, int32
    # lengths and a validity byte per row
    text_bytes = sum(n * (1 << max(int(lens.max()) - 1, 3).bit_length())
                     + 5 * n for _, lens, _ in raw.values())
    log(f"  raw text made into views in {time.perf_counter() - t0:.2f} s; "
        f"{text_bytes / 1e9:.3f} GB of text as byte matrices")
    must = {"tlc_hourly": ("seg_sum_f32", "seg_sum_f64"),
            "tlc_duplicates": ("murmur3_long",)}
    runs = {}
    for name, text in TLC_QUERIES.items():
        t_query = time.perf_counter()
        query = SqlQuery(sess, text)
        q_seg: dict = {}
        q_mm: list = []
        with recording_seg_sums(K, q_seg), \
                recording(K, "murmur3_long", q_mm):
            got, launches, cold_s = drive(f"tlc {name}", query.collect, K,
                                          torch, must.get(name, ()), by_path)
        tlc_check(name, got, oracles.result())
        for kname in SEG_SUM_BUILDS:
            if q_seg[kname]:
                err[kname] = max(err[kname], check_seg_sum_calls(
                    K, torch, kname, f"tlc {name}", q_seg[kname]))
        if q_mm:
            err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
                K, torch, f"tlc {name}", q_mm))
        del q_seg, q_mm
        log(f"  tlc {name}: {got.num_rows} rows match the oracle exactly; "
            f"{time.perf_counter() - t_query:.2f} s")
        runs[name] = dict(query=query, cold_s=cold_s, launches=launches,
                          rows=got.num_rows)
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in RIG_KERNELS}
    log(f"  the TLC queries' launches of the hand kernels: {total}")
    return runs


def tlc_times(runs: dict, torch) -> list:
    """Phase 4's part for phase 3l: each query cold, warm (median of 3) and
    profiled once; the ``tlc`` JSON line."""
    log(f"  the TLC queries: cold, warm (median of {SQL_WARM_RUNS}) and a "
        f"profile of one warm run of {PROFILED['tlc']}")
    report = []
    for qname, rr in runs.items():
        wm, tms = warm_ms(rr["query"], torch, SQL_WARM_RUNS)
        prof = profile_fields("tlc", qname, rr["query"], torch, forbid=())
        log(f"  tlc {qname}: cold {rr['cold_s'] * 1e3:.3f} ms; warm median "
            f"{wm:.3f} ms of {[round(t, 3) for t in tms]} ms")
        report.append({
            "query": qname, "rows": rr["rows"],
            "cold_ms": rr["cold_s"] * 1e3, "warm_ms": wm, **prof,
            "launches": {k: rr["launches"][k] for k in RIG_KERNELS}})
    log(json.dumps({"tlc": report}))
    return report


def make_tlc_matrix_data(rows: int, seed: int = TLC_SEED):
    """Phase 3l's matrix inputs: u unique; s text with nulls, empty and
    multi-byte strings, numbers, decimals, dates and timestamps as text
    (good and malformed, zones and offsets); ts timestamps with nulls,
    micros before 1970, leap days and the last second of 9999; d dates;
    i ints at their limits; m decimal(12,2) and w decimal(38,10) with
    38-digit values."""
    from spark_rapids_tpu_torch.columnar.convert import HostDecimals
    from spark_rapids_tpu_torch import types as TT
    rng = np.random.default_rng(seed)
    specials = ["", " ", "a", "é中ñ", "ß", "straße", "Hello World", "  x  ",
                "0", "-0", "+7", "2147483647", "-2147483648", "2147483648",
                "9223372036854775807", "-9223372036854775808",
                "9223372036854775808", "1.5", "-0.005", "1e10", "1E-3",
                "inf", "-Infinity", "NaN", "nan", "abc", "12.3.4", ".5",
                "5.", "99999999.995", "1234567890123456789012345678.5",
                "true", "FALSE", "y", "no", "2019-01-01", "2019-1-5",
                "2020-02-29", "2019-02-29", "2019-01-01 12:34:56",
                "2019-01-01T12:34:56.123456Z", "2019-01-01 12:34:56.5 +05:30",
                "2019-01-01 12:34:56 UTC", "2019-01-01 25:00:00",
                "1969-12-31 23:59:59.999999", "9999-12-31 23:59:59",
                "0001-01-01 00:00:00", "2019-01-01 12:34", "a,b,,c",
                "x-y-z", "中文,中", "😀😀", "tEsT cAsE", "2019-01-15 10:61:00"]
    s = np.array(specials, dtype=object)[rng.integers(0, len(specials),
                                                      rows)]
    s[rng.random(rows) < 0.1] = None
    day_us = 86_400_000_000
    ts_specials = np.array([0, -1, 1, 951_782_400 * 10 ** 6,
                            1_582_934_400 * 10 ** 6 + 1,
                            253_402_300_799 * 10 ** 6 + 999_999,
                            -62_135_596_800 * 10 ** 6, -day_us * 365 - 7,
                            1_546_300_800 * 10 ** 6 + 123_450],
                           dtype=np.int64)
    ts = rng.integers(-62_135_596_800 * 10 ** 6, 253_402_300_799 * 10 ** 6,
                      rows)
    hit = rng.random(rows) < 0.2
    ts[hit] = ts_specials[rng.integers(0, ts_specials.size, int(hit.sum()))]
    lo_day = -719_162
    d = rng.integers(lo_day, 2_932_896, rows).astype(np.int32)
    i = rng.integers(-1000, 1000, rows).astype(np.int32)
    i[rng.random(rows) < 0.05] = 2 ** 31 - 1
    i[rng.random(rows) < 0.05] = -2 ** 31
    m = np.ma.masked_array(rng.integers(-10 ** 11, 10 ** 11, rows),
                           mask=rng.random(rows) < 0.1)
    w_lo, w_hi = _words(rng, rows)
    w_ok = rng.random(rows) >= 0.1
    data = {
        "u": np.arange(rows, dtype=np.int64),
        "s": np.ma.masked_array(np.where(s == None, "", s),  # noqa: E711
                                mask=s == None),  # noqa: E711
        "ts": np.ma.masked_array(ts.view("datetime64[us]"),
                                 mask=rng.random(rows) < 0.1),
        "d": np.ma.masked_array(d.astype(np.int64).view("datetime64[D]"),
                                mask=rng.random(rows) < 0.1),
        "i": np.ma.masked_array(i, mask=rng.random(rows) < 0.1),
        "m": HostDecimals.from_unscaled(m, 12, 2),
        "w": HostDecimals(np.where(w_ok, w_lo, 0), np.where(w_ok, w_hi, 0),
                          w_ok, TT.DecimalType(38, 10)),
    }
    return data


#: phase 3l's matrix: every new function and cast of the slice
TLC_MATRIX = {
    "casts_from_text": """SELECT u, CAST(s AS INT) a, CAST(s AS BIGINT) b,
        CAST(s AS TINYINT) c, CAST(s AS DOUBLE) e, CAST(s AS FLOAT) f,
        CAST(s AS BOOLEAN) g, CAST(s AS DATE) h, CAST(s AS TIMESTAMP) k,
        CAST(s AS DECIMAL(10,2)) l, CAST(s AS DECIMAL(38,10)) n,
        to_timestamp(s) o, to_timestamp(s, 'yyyy-MM-dd HH:mm:ss') p,
        unix_timestamp(s, 'yyyy-MM-dd') q FROM m""",
    "casts_to_text": """SELECT u, CAST(ts AS STRING) a, CAST(d AS STRING) b,
        CAST(i AS STRING) c, CAST(m AS STRING) e, CAST(w AS STRING) f,
        CAST(i > 0 AS STRING) g, CAST(CAST(i AS SMALLINT) AS STRING) h,
        CAST(ts AS DATE) k, CAST(d AS TIMESTAMP) l, CAST(ts AS BIGINT) n,
        CAST(ts AS DOUBLE) o, CAST(i AS TIMESTAMP) p FROM m""",
    "timestamps": """SELECT u, hour(ts) a, minute(ts) b, second(ts) c,
        year(ts) e, month(ts) f, dayofmonth(ts) g, dayofweek(ts) h,
        date_format(ts, 'yyyy-MM-dd HH:mm:ss.SSSSSS') k,
        unix_timestamp(ts) l, unix_micros(ts) n,
        from_unixtime(unix_timestamp(ts)) o, ts + INTERVAL 90 MINUTES p,
        d + INTERVAL 3 HOURS q, ts - INTERVAL 1 MONTH r,
        months_between(ts, d) v, add_months(ts, 13) x, trunc(d, 'quarter') y,
        datediff(ts, d) z, from_utc_timestamp(ts, '+05:30') z1,
        timestamp_seconds(i) z2, timestamp_millis(u) z3, last_day(ts) z4
        FROM m""",
    "strings": """SELECT u, upper(s) a, lower(s) b, initcap(s) c,
        reverse(s) e, concat(s, '|', s) f, concat_ws('-', s, NULL, s) g,
        s || '!' h, instr(s, 'a') k, locate('l', s, 3) l, lpad(s, 6, 'xy') n,
        rpad(s, 3, '*') o, trim(s) p, ltrim(s) q, rtrim(s) r,
        repeat(s, 2) v, replace(s, 'a', 'AA') x,
        substring_index(s, ',', 2) y, substring_index(s, ',', -1) z,
        translate(s, 'abc', 'x') z1, substring(s, 2) z2, nvl(s, 'none') z3,
        ifnull(ts, TIMESTAMP '2000-01-01 00:00:00') z4,
        s LIKE '%!%%' ESCAPE '!' z5 FROM m""",
    "keys": """SELECT ts, count(*) c, min(u) a, max(d) b, sum(i) e FROM m
        GROUP BY ts""",
    "decimal_windows": """SELECT u, sum(m) OVER (PARTITION BY i % 7 ORDER BY u
          ROWS BETWEEN 3 PRECEDING AND CURRENT ROW) a,
        avg(m) OVER (PARTITION BY i % 7 ORDER BY u
          ROWS BETWEEN 3 PRECEDING AND 2 FOLLOWING) b,
        max(w) OVER (PARTITION BY i % 7 ORDER BY u
          ROWS BETWEEN 5 PRECEDING AND CURRENT ROW) c,
        min(w) OVER (PARTITION BY i % 7) e,
        count(*) OVER (PARTITION BY i % 7 ORDER BY m
          RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) f,
        sum(w) OVER (PARTITION BY i % 7 ORDER BY w
          RANGE BETWEEN 100 PRECEDING AND 100 FOLLOWING) g,
        lag(ts) OVER (PARTITION BY i % 7 ORDER BY u) h,
        w * CAST(m AS DECIMAL(38,30)) k FROM m""",
}


def collect_cols(sess, text) -> dict:
    """A statement's (or a DataFrame's) result as numpy arrays per column,
    without host
    objects: fixed-width data (a decimal's two words), a string's bytes
    (past its length zeroed) and lengths, and the validity; nulls
    zeroed."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import dec_words
    plan = sess.physical_plan(sess.sql(text) if isinstance(text, str)
                              else text)
    batch = ColumnarBatch.concat(plan.execute_all())
    n = batch.num_rows_int
    out = {}
    for name, c in zip(batch.names, batch.columns):
        valid = c.validity[:n].cpu().numpy()
        if c.lengths is not None:
            lens = np.where(valid, c.lengths[:n].cpu().numpy(), 0)
            chars = c.data[:n].cpu().numpy()
            pos = np.arange(chars.shape[1])[None, :]
            words = [np.where(pos < lens[:, None], chars, 0), lens]
        elif isinstance(c.dtype, TT.DecimalType):
            words = [w[:n].cpu().numpy() for w in dec_words(c)]
        else:
            words = [c.data[:n].cpu().numpy()]
        out[name] = [np.where(valid.reshape(-1, *([1] * (w.ndim - 1))), w,
                              np.zeros((), w.dtype)) for w in words] + [valid]
    return out


def check_same_cols(a: dict, b: dict, label: str, key: str = "u") -> None:
    """Two ``collect_cols`` results, rows matched by ``key`` (or, with no
    ``key`` column, by the first column's words): every column equal,
    NaN equal to NaN, string bytes compared at the wider width."""
    if list(a) != list(b):
        raise AssertionError(f"{label}: columns {list(a)} vs {list(b)}")

    def order(res):
        if key in res:
            return np.argsort(res[key][0], kind="stable")
        first = next(iter(res.values()))
        return np.lexsort([first[-1]] + [w for w in first[:-1]
                                         if w.ndim == 1][::-1])
    oa, ob = order(a), order(b)
    for name in a:
        for x, y in zip(a[name], b[name]):
            x, y = x[oa], y[ob]
            if x.ndim == 2 and x.shape[1] != y.shape[1]:
                wdt = max(x.shape[1], y.shape[1])
                x = np.pad(x, ((0, 0), (0, wdt - x.shape[1])))
                y = np.pad(y, ((0, 0), (0, wdt - y.shape[1])))
            if x.shape != y.shape or not np.array_equal(
                    x, y, equal_nan=np.issubdtype(x.dtype, np.floating)):
                raise AssertionError(f"{label}: column {name} differs")


def tlc_matrix_side(srt, device: str, data) -> dict:
    """TLC_MATRIX's results on one device: (name -> collect_cols, name ->
    seconds)."""
    sm = srt.session(device=device)
    sm.create_dataframe(data, num_partitions=4).createOrReplaceTempView("m")
    out, secs = {}, {}
    for name, text in TLC_MATRIX.items():
        t0 = time.perf_counter()
        out[name] = collect_cols(sm, text)
        secs[name] = time.perf_counter() - t0
        if not next(iter(out[name].values()))[-1].size:
            raise AssertionError(f"tlc matrix {name}: no rows on {device}")
    return out, secs


def start_tlc_matrix_cpu(srt):
    """The matrix's inputs and its CPU side, started in a thread: it runs
    beside the generation, the oracles and the main path's queries on the
    card (torch's CPU ops release the interpreter lock).  Returns (pool,
    future, data)."""
    data = make_tlc_matrix_data(TLC_MATRIX_ROWS)
    pool = ThreadPoolExecutor(1)
    return pool, pool.submit(tlc_matrix_side, srt, "cpu", data), data


def tlc_matrix(srt, torch, started) -> None:
    """Phase 3l's matrix: TLC_MATRIX over TLC_MATRIX_ROWS rows at 4
    partitions on cuda, held against the CPU side ``started`` began (at
    ``finish_cpu_sides``): every column equal."""
    pool, future, data = started
    log(f"  the text-to-typed matrix: {TLC_MATRIX_ROWS} rows at 4 partitions, "
        f"every new function and cast, on cuda and on the cpu")
    on_card, card_secs = tlc_matrix_side(srt, "cuda", data)
    for name in TLC_MATRIX:
        rows = next(iter(on_card[name].values()))[-1].size
        log(f"    cuda {name}: {card_secs[name]:.3f} s, {rows} rows")

    def tlc_check(side):
        on_cpu, secs = side
        pool.shutdown()
        for name in TLC_MATRIX:
            rows = next(iter(on_cpu[name].values()))[-1].size
            log(f"    cpu {name}: {secs[name]:.3f} s, {rows} rows")
            check_same_cols(on_card[name], on_cpu[name], f"tlc matrix {name}",
                            key="u" if name != "keys" else "")
        log("  the text-to-typed matrix agrees on cuda and the cpu: every "
            "column equal")
    cpu_side("text to typed", future, tlc_check)


# --------------------------------------------------------------------------
# phase 3m: Parquet -- phase 3k's TPC-H tables written by the port and read
# back, the scale rig's scan leg, and a round-trip matrix
# --------------------------------------------------------------------------

#: where phase 3m writes its files, under the checkout's build/ (gitignored)
PARQUET_DIR = os.path.join("build", "chip_smoke_parquet")
#: part files per table (one per partition of the writing DataFrame)
PARQUET_PARTS = 4
#: rows of phase 3m's round-trip matrix
PARQUET_MATRIX_ROWS = MATRIX_ROWS
PARQUET_CODECS = ("none", "snappy", "gzip")
#: warm runs per query of phase 3m (files in the page cache): the median
PARQUET_WARM_RUNS = 1
#: the writing session: lineitem's orderBy makes one range partition (and
#: so one part file) per part, never coalesced by AQE
PARQUET_WRITE_CONF = {"spark.sql.shuffle.partitions": PARQUET_PARTS,
                      "spark.sql.adaptive.coalescePartitions.minRows": 0}


def parquet_root() -> str:
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        PARQUET_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root


def parquet_files(path: str):
    """(files, row groups, bytes) of a written directory, from the port's
    own footer reader."""
    from spark_rapids_tpu_torch.io_ import parquet_meta as M
    from spark_rapids_tpu_torch.io_.registry import expand_paths
    files = expand_paths([path])
    groups = sum(len(M.read_footer(f).row_groups) for f in files)
    return len(files), groups, sum(os.path.getsize(f) for f in files)


def write_tpch_parquet(srt, torch, td, root: str) -> dict:
    """Phase 3m, step 1: phase 3k's decimal tables through
    ``create_dataframe(...).write.parquet(dir)`` at PARQUET_PARTS
    partitions (one part file each, snappy), lineitem sorted by
    l_shipdate first (``orderBy``, at PARQUET_PARTS shuffle partitions), as
    date-clustered fact tables are laid out."""
    from spark_rapids_tpu_torch.columnar import HostDecimals
    phase("3m", f"Parquet. Phase 3k's decimal tables "
        f"({td['lineitem']['l_quantity'].size} lineitem rows) written by "
        "the port "
        f"({PARQUET_PARTS} part files each, snappy; lineitem in l_shipdate "
        "order)")
    sess = srt.session(conf=PARQUET_WRITE_CONF)
    out = {}
    for name, cols in td.items():
        host = {c: (HostDecimals.from_unscaled(v, DEC_PRECISION, DEC_SCALE)
                    if c in DEC_MONEY.get(name, ()) else v)
                for c, v in cols.items()}
        df = sess.create_dataframe(host, num_partitions=PARQUET_PARTS)
        if name == "lineitem":
            df = df.orderBy("l_shipdate")
        path = os.path.join(root, name)
        t0 = time.perf_counter()
        stats = df.write.parquet(path)
        secs = time.perf_counter() - t0
        files, groups, nbytes = parquet_files(path)
        rows = len(next(iter(cols.values())))
        if stats.num_rows != rows or stats.num_files != files:
            raise AssertionError(f"write {name}: {stats.num_rows} rows in "
                                 f"{stats.num_files} files, want {rows}")
        out[name] = dict(rows=rows, files=files, row_groups=groups,
                         bytes=nbytes, seconds=secs)
        log(f"  {name}: {rows} rows, {files} files, {groups} row groups, "
            f"{nbytes} bytes in {secs:.3f} s")
    if out["lineitem"]["files"] != PARQUET_PARTS:
        raise AssertionError("lineitem: not one file per partition")
    return out


def scans_of(plan):
    """The file scans of a plan that has run (an adaptive join's chosen
    plan included)."""
    from spark_rapids_tpu_torch.io_.exec import FileScanExec
    seen, out, stack = set(), [], [plan]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        if isinstance(node, FileScanExec):
            out.append(node)
        stack.extend(node.children)
        stack.extend(node.plan_children())
    return out


def check_scans(plan, label: str) -> dict:
    """Every file of every scan of the plan decoded on the card, with every
    column, unless pruning left it no row group; returns the scans' row
    groups (read, skipped) and files."""
    total = {"files": 0, "decoded": 0, "columns": 0, "read": 0,
             "skipped": 0}
    for scan in scans_of(plan):
        m = scan.metrics
        ncols = len(scan.output)
        if scan.device.type != "cuda":
            raise AssertionError(f"{label}: a scan on {scan.device}")
        if m.get("filesDecoded", 0) + m.get("filesPrunedAway", 0) != \
                len(scan.files) or m.get("columnsDecoded", 0) != \
                m.get("filesDecoded", 0) * ncols:
            raise AssertionError(f"{label}: scan of {scan.node.paths}: "
                                 f"{m} over {len(scan.files)} files")
        total["files"] += len(scan.files)
        total["decoded"] += m.get("filesDecoded", 0)
        total["columns"] += m.get("columnsDecoded", 0)
        total["read"] += m.get("rowGroupsRead", 0)
        total["skipped"] += m.get("rowGroupsPruned", 0)
    if not total["files"]:
        raise AssertionError(f"{label}: no file scan ran")
    return total


def run_parquet_queries(srt, K, torch, td, root: str, by_path,
                        err) -> dict:
    """Phase 3m, step 2: every table read back with ``session.read.parquet``
    as a view, default configuration, and phase 3k's 21 texts over them,
    each exact on its first call by its decimal oracle, every hand-kernel
    call replayed against its plain version (seg_sum_f32 must launch in
    q1, murmur3_long in q18), every file and column decoded on the card,
    and q6 skipping row groups by l_shipdate."""
    log("  the 21 TPC-H texts over the tables read back from Parquet "
        "(session.read.parquet views, default configuration)")
    psess = srt.session()
    for name in td:
        psess.read.parquet(os.path.join(root, name)) \
            .createOrReplaceTempView(name)
    must = {"tpch_q1_sql": ("seg_sum_f32",), "q18": ("murmur3_long",)}
    runs = {}
    for name, text, check in DEC_SQL_QUERIES:
        t_query = time.perf_counter()
        query = SqlQuery(psess, text)
        q_seg: dict = {}
        q_mm: list = []
        with recording_seg_sums(K, q_seg), \
                recording(K, "murmur3_long", q_mm):
            got, launches, cold_s = drive(f"parquet {name}", query.collect,
                                          K, torch, must.get(name, ()),
                                          by_path)
        check_later(f"parquet {name}", check, got, td)
        for kname in SEG_SUM_BUILDS:
            if q_seg[kname]:
                err[kname] = max(err[kname], check_seg_sum_calls(
                    K, torch, kname, f"parquet {name}", q_seg[kname]))
        if q_mm:
            err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
                K, torch, f"parquet {name}", q_mm))
        del q_seg, q_mm
        scans = check_scans(psess.last_plan, f"parquet {name}")
        if name == "tpch_q6_sql" and scans["skipped"] < 1:
            raise AssertionError("parquet tpch_q6_sql skipped no row group "
                                 "by l_shipdate")
        log(f"  parquet {name}: {got.num_rows} rows (held exactly against "
            f"its decimal oracle in the background); scans "
            f"{json.dumps(scans)}; {time.perf_counter() - t_query:.2f} s")
        runs[name] = dict(query=query, cold_s=cold_s, launches=launches,
                          rows=got.num_rows, scans=scans)
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in RIG_KERNELS}
    log(f"  the Parquet queries' launches of the hand kernels: {total}")
    return runs


def memory_decimal_warm(srt, torch, td) -> dict:
    """Phase 3k's in-memory decimal views, each query's warm ms (median of
    PARQUET_WARM_RUNS after one warm-up), for ``--parquet`` alone."""
    sess = srt.session()
    register_tpch_decimal_views(sess, td)
    out = {}
    for name, text, check in DEC_SQL_QUERIES:
        query = SqlQuery(sess, text)
        check(query.collect(), td)
        torch.cuda.synchronize()
        out[name] = warm_ms(query, torch, PARQUET_WARM_RUNS)[0]
    return out


def parquet_times(runs: dict, memory_warm: dict, torch) -> list:
    """Phase 4's part for phase 3m: each query cold, warm (median of
    PARQUET_WARM_RUNS, the files in the page cache), the scan's split over
    those warm runs (host ms: footer, page headers, decompression, walks;
    upload bytes and ms; the copy and decode spans on the stream by CUDA
    events, ``decode_stats.spans``: a decode span includes the idle gaps
    while Python enqueues the decode, so it bounds its device time from
    above), row groups
    read and skipped, and one light profile; beside the same query's warm
    ms over phase 3k's in-memory tables; the ``parquet`` JSON line.  The
    host ms are summed over the threads that plan files and columns at
    once, so they can pass the wall time."""
    from spark_rapids_tpu_torch.io_ import decode_stats as DS
    log(f"  the 21 TPC-H texts over Parquet: cold, warm (median of "
        f"{PARQUET_WARM_RUNS}, files in the page cache) with the scan's "
        "host and upload ms, copy and decode spans, a profile of one warm "
        f"run of {PROFILED['parquet']}, and the in-memory decimal tables' "
        "warm ms")
    report = []
    for qname, rr in runs.items():
        with DS.spans():
            wm, tms = warm_ms(rr["query"], torch, PARQUET_WARM_RUNS)
            split = DS.report()
        per = 1.0 / PARQUET_WARM_RUNS
        prof = profile_fields("parquet", qname, rr["query"], torch)
        mw = memory_warm.get(qname)
        entry = {
            "query": qname, "rows": rr["rows"],
            "cold_ms": rr["cold_s"] * 1e3, "warm_ms": wm,
            "memory_warm_ms": mw,
            "scan_host_ms": split["host_s"] * 1e3 * per,
            "upload_bytes": split["upload_bytes"] * per,
            "upload_ms": split["upload_s"] * 1e3 * per,
            "copy_span_ms": split["copy_span_ms"] * per,
            "decode_span_ms": split["decode_span_ms"] * per,
            "files_decoded": split["files_engaged"] * per,
            "row_groups_read": split["row_groups_read"] * per,
            "row_groups_skipped": split["row_groups_skipped"] * per,
            **prof,
            "launches": {k: rr["launches"][k] for k in RIG_KERNELS}}
        report.append(entry)
        log(f"  parquet {qname}: cold {entry['cold_ms']:.3f} ms; warm median "
            f"{wm:.3f} ms of {[round(t, 3) for t in tms]} ms (in memory "
            f"{mw:.3f}); scan host {entry['scan_host_ms']:.3f} ms, upload "
            f"{entry['upload_bytes']:.0f} B staged in "
            f"{entry['upload_ms']:.3f} ms, copy span "
            f"{entry['copy_span_ms']:.3f} ms, decode span "
            f"{entry['decode_span_ms']:.3f} ms; row groups "
            f"{entry['row_groups_read']:.0f} read, "
            f"{entry['row_groups_skipped']:.0f} skipped")
    log(json.dumps({"parquet": report}))
    return report


def parquet_rig_leg(srt, K, torch, fact, root: str) -> dict:
    """Phase 3m, step 3: the scale rig's Parquet leg
    (``scan_engagement_report``: its filter-and-aggregate, the rig's
    q1_filter_agg) over phase 3h's fact table, written by the port and read
    back; exact by the rig's check; every file engaged, none declined."""
    from spark_rapids_tpu_torch.io_ import decode_stats as DS
    from spark_rapids_tpu_torch.sql import functions as F
    sess = srt.session()
    path = os.path.join(root, "fact")
    t0 = time.perf_counter()
    sess.create_dataframe(fact, num_partitions=PARQUET_PARTS) \
        .write.parquet(path)
    files, groups, nbytes = parquet_files(path)
    log(f"  the rig's fact table ({len(fact['q'])} rows): {files} files, "
        f"{groups} row groups, {nbytes} bytes in "
        f"{time.perf_counter() - t0:.3f} s")
    df = sess.read.parquet(path)
    q = (df.filter(df.q < 50).groupBy("q")
         .agg(F.sum(df.v).alias("sv"), F.count("*").alias("c"))
         .orderBy("q"))
    DS.reset()
    got, _, _ = drive("parquet rig scan leg", q.collect, K, torch)
    rig_q1_check(got, {"fact": fact})
    rep = DS.report()
    out = {"files": files, "files_engaged": rep["files_engaged"],
           "files_declined": rep["files_declined"],
           "bytes_engaged": rep["bytes_engaged"],
           "columns_engaged": rep["columns_engaged"]}
    if rep["files_engaged"] != files or rep["files_declined"]:
        raise AssertionError(f"parquet rig leg: {out}")
    log(f"  the rig's Parquet leg matches its check; {json.dumps(out)}")
    return out


def make_parquet_matrix_data(rows: int, seed: int = SEED):
    """Every type the port has, with nulls: booleans, the four integer
    widths at their limits, floats with NaN, +-inf and -0.0, decimal(12,2),
    (18,4) and (38,10) at +-(10^p - 1), dates 0001-01-01 to 9999-12-31,
    timestamps from 1900 to 2100 (micros before 1970), strings (empty,
    multi-byte, 200 bytes), binary with zero bytes, and a high-cardinality
    string (a value per row) whose dictionary passes 1 MiB; ``u`` numbers
    the rows."""
    from spark_rapids_tpu_torch import types as TT
    from spark_rapids_tpu_torch.columnar import HostDecimals
    from spark_rapids_tpu_torch.columnar.convert import HostStrings
    from spark_rapids_tpu_torch.columnar.column import int128_words
    rng = np.random.default_rng(seed)

    def nulls(a, frac=0.1):
        return np.ma.MaskedArray(a, mask=rng.random(rows) < frac)

    def ints(dt):
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, rows, dtype=np.int64,
                         endpoint=True).astype(dt)
        a[:4] = [info.min, info.max, 0, -1]
        return nulls(a)

    def floats(dt):
        a = (rng.standard_normal(rows) * 1e6).astype(dt)
        specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                             np.finfo(dt).max, np.finfo(dt).tiny], dt)
        pick = rng.random(rows) < 0.05
        a[pick] = specials[rng.integers(0, specials.size, int(pick.sum()))]
        return nulls(a)

    def decimals(precision, scale):
        big = 10 ** precision - 1
        if precision <= 18:
            lo = rng.integers(-big, big, rows, dtype=np.int64, endpoint=True)
            lo[:2] = [big, -big]
            hi = lo >> 63
        else:
            hi = rng.integers(-(1 << 62), 1 << 62, rows, dtype=np.int64)
            lo = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                              rows, dtype=np.int64)
            for i, v in enumerate((big, -big)):
                lo[i], hi[i] = int128_words(v)
        valid = rng.random(rows) >= 0.1
        return HostDecimals(np.where(valid, lo, 0), np.where(valid, hi, 0),
                            valid, TT.DecimalType(precision, scale))

    def vocab_strings(vocab, probs, binary=False):
        raw = [v if isinstance(v, bytes) else v.encode("utf-8")
               for v in vocab]
        sizes = np.array([len(v) for v in raw], np.int64)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        flat = np.frombuffer(b"".join(raw), np.uint8)
        pick = rng.choice(len(raw), rows, p=probs)
        valid = rng.random(rows) >= 0.1
        lens = np.where(valid, sizes[pick], 0)
        offsets = np.zeros(rows + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        within = np.arange(offsets[-1]) - np.repeat(offsets[:-1], lens)
        data = flat[np.repeat(starts[pick], lens) + within]
        return HostStrings(offsets, data, valid, binary)

    u = np.arange(rows, dtype=np.int64)
    digits = ((u[:, None] // 10 ** np.arange(14, -1, -1)) % 10 + 48
              ).astype(np.uint8)
    hc = np.concatenate([np.full((rows, 1), ord("h"), np.uint8), digits], 1)
    days = rng.integers(np.datetime64("0001-01-01").astype(np.int64),
                        np.datetime64("9999-12-31").astype(np.int64),
                        rows, endpoint=True)
    days[:2] = [np.datetime64("0001-01-01").astype(np.int64),
                np.datetime64("9999-12-31").astype(np.int64)]
    micros = rng.integers(-70 * 365 * 86400 * 10 ** 6,
                          130 * 365 * 86400 * 10 ** 6, rows)
    words = ["", "a", "abc", "é中ñ", "naïve café", "x" * 200,
             "Ünïcödé " * 25, "k" * 17, "zz"]
    bins = [b"", b"\x00", b"\x00\x01\x02", bytes(range(256)), b"ab\x00cd"]
    return {
        "u": u,
        "b": nulls(rng.random(rows) < 0.5),
        "i8": ints(np.int8), "i16": ints(np.int16), "i32": ints(np.int32),
        "i64": ints(np.int64),
        "f32": floats(np.float32), "f64": floats(np.float64),
        "d12": decimals(12, 2), "d18": decimals(18, 4),
        "d38": decimals(38, 10),
        "dt": nulls(days.astype("datetime64[D]")),
        "ts": nulls(micros.astype("datetime64[us]")),
        "s": vocab_strings(words, [0.2, 0.1, 0.2, 0.1, 0.1, 0.05, 0.05,
                                   0.1, 0.1]),
        "bin": vocab_strings(bins, [0.2] * 5, binary=True),
        "hc": HostStrings(np.arange(rows + 1, dtype=np.int64) * 16,
                          hc.reshape(-1), np.ones(rows, bool)),
    }


def parquet_phase(srt, K, torch, td, fact, by_path, err) -> dict:
    """Phase 3m: steps 1-4, then the check that nothing imported pyarrow.
    Returns the queries' runs and the files' root."""
    root = parquet_root()
    write_tpch_parquet(srt, torch, td, root)
    runs = run_parquet_queries(srt, K, torch, td, root, by_path, err)
    parquet_rig_leg(srt, K, torch, fact, root)
    parquet_matrix(srt, torch, root)
    if "pyarrow" in sys.modules:
        raise AssertionError("phase 3m imported pyarrow")
    log("  phase 3m ran without pyarrow (not in sys.modules)")
    return {"runs": runs, "root": root}


def parquet_cleanup(root: str) -> None:
    import shutil
    shutil.rmtree(root, ignore_errors=True)


def _bits(cols: dict) -> dict:
    """``collect_cols`` with each float column's words as their bits, so
    -0.0 and NaN payloads count."""
    out = {}
    for name, words in cols.items():
        out[name] = [w.view(np.int32 if w.dtype == np.float32 else np.int64)
                     if w.dtype.kind == "f" else w for w in words]
    return out


def parquet_matrix(srt, torch, root: str) -> None:
    """Phase 3m, step 4: the round-trip matrix written by the port with
    each codec and read back on cuda and on the cpu (the cpu's reads in the
    background, ``cpu_side``), every column equal to the input's bits;
    then partitionBy, the four save modes, cache() and parquet.`path` from
    SQL."""
    from spark_rapids_tpu_torch.io_ import parquet_meta as M
    from spark_rapids_tpu_torch.io_.registry import expand_paths
    log(f"  the round-trip matrix: {PARQUET_MATRIX_ROWS} rows of every "
        f"type, written with each of {PARQUET_CODECS}, read on cuda and on "
        "the cpu")
    data = make_parquet_matrix_data(PARQUET_MATRIX_ROWS)
    scpu = srt.session(device="cpu")
    sgpu = srt.session()
    src = sgpu.create_dataframe(data, num_partitions=2)
    paths = {}
    for codec in PARQUET_CODECS:
        path = paths[codec] = os.path.join(root, f"matrix_{codec}")
        t0 = time.perf_counter()
        src.write.option("compression", codec).parquet(path)
        files = expand_paths([path])
        md = M.read_footer(files[0])
        encs = {M.ENCODING_NAMES[e] for e in md.row_groups[0].columns[
            list(data).index("hc")].encodings}
        if "PLAIN" not in encs or "RLE_DICTIONARY" not in encs:
            raise AssertionError("matrix: hc did not fall back from its "
                                 f"dictionary to PLAIN ({encs})")
        log(f"    {codec}: written in {time.perf_counter() - t0:.3f} s "
            f"({sum(os.path.getsize(f) for f in files)} bytes)")

    def cpu_reads():
        want = _bits(collect_cols(scpu, scpu.create_dataframe(data)))
        got = {c: _bits(collect_cols(scpu, scpu.read.parquet(p)))
               for c, p in paths.items()}
        return want, got
    on_card = {}
    for codec, path in paths.items():
        t0 = time.perf_counter()
        on_card[codec] = _bits(collect_cols(sgpu, sgpu.read.parquet(path)))
        log(f"    {codec}: read on cuda in {time.perf_counter() - t0:.3f} s")
    parquet_small_cases(sgpu, scpu, data, root)

    def parquet_check(side):
        want, got = side
        for codec in PARQUET_CODECS:
            check_same_cols(on_card[codec], want, f"parquet matrix {codec} "
                            "on cuda")
            check_same_cols(got[codec], want, f"parquet matrix {codec} on "
                            "cpu")
        import shutil
        for path in paths.values():
            shutil.rmtree(path, ignore_errors=True)
        log("  the Parquet matrix reads back equal on cuda and the cpu with "
            "every codec (bits of floats; hc's dictionary falls back to "
            "PLAIN)")
    cpu_side("parquet", cpu_reads, parquet_check)


def parquet_small_cases(sgpu, scpu, data, root: str) -> None:
    """partitionBy, the four save modes, cache() and parquet.`path` over
    the matrix's first 10,000 rows, on the card."""
    small = {k: v[:10_000] for k, v in data.items()}
    sdf = sgpu.create_dataframe(small, num_partitions=2)
    swant = _bits(collect_cols(scpu, scpu.create_dataframe(small)))
    part = os.path.join(root, "partitioned")
    stats = sgpu.create_dataframe({"u": small["u"], "k": small["u"] % 3,
                                   "s": small["s"]}).write.partitionBy(
        "k").parquet(part)
    dirs = sorted(d for d in os.listdir(part) if d.startswith("k="))
    if dirs != ["k=0", "k=1", "k=2"] or sorted(stats.partition_paths) != dirs:
        raise AssertionError(f"partitionBy: {dirs}")
    k1 = sgpu.read.parquet(os.path.join(part, "k=1"))
    if "k" in k1.columns or k1.count() != int((small["u"] % 3 == 1).sum()):
        raise AssertionError("partitionBy: k=1 holds the wrong rows")
    modes = os.path.join(root, "modes")
    sdf.write.parquet(modes)
    try:
        sdf.write.parquet(modes)
        raise AssertionError("errorifexists wrote over a directory")
    except FileExistsError:
        pass
    sdf.write.mode("ignore").parquet(modes)
    sdf.write.mode("append").parquet(modes)
    if sgpu.read.parquet(modes).count() != 20_000:
        raise AssertionError("append: not twice the rows")
    sdf.write.mode("overwrite").parquet(modes)
    check_same_cols(_bits(collect_cols(sgpu, sgpu.read.parquet(modes))),
                    swant, "save modes")
    cached = sdf.cache()
    check_same_cols(_bits(collect_cols(sgpu, cached)), swant, "cache()")
    check_same_cols(_bits(collect_cols(sgpu, cached)), swant,
                    "cache(), second scan")
    check_same_cols(_bits(collect_cols(
        sgpu, f"SELECT * FROM parquet.`{modes}`")), swant,
        "parquet.`path`")
    log("  partitionBy (Hive k=v directories), the four save modes, "
        "cache() and parquet.`path` from SQL give the input's rows")


def seg_sum2_ab(torch, n: int = 1 << 21, live: int = 1_500_000,
                groups: int = 1 << 19) -> None:
    """seg_sum2's double sums at a merge's shape (``live`` partial rows of
    a 2^21-row buffer into ``groups`` groups, one slot; the rest dead
    padding): the sorted, fixed-order form against the ``index_add_`` it
    replaced and against ``index_put_(accumulate=True)``, the other
    fixed-order torch call, in one call, in turns; and the same bits on
    reruns."""
    from spark_rapids_tpu_torch.ops.segmented import _spare, seg_sum2
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    data = torch.rand(n, 1, generator=g, device="cuda",
                      dtype=torch.float64) * 1e6
    ids = torch.randint(0, groups, (n,), generator=g, device="cuda")
    ids[live:] = n

    def index_add():
        out = torch.zeros(groups + 1, 1, dtype=torch.float64,
                          device="cuda")
        return out.index_add_(0, _spare(ids, groups), data)[:groups]

    def index_put():
        out = torch.zeros(groups + 1, 1, dtype=torch.float64,
                          device="cuda")
        out.index_put_((_spare(ids, groups),), data, accumulate=True)
        return out[:groups]

    def sorted_sum():
        return seg_sum2(data, ids, groups)
    times = {"index_add_": [], "sorted": [], "index_put_": []}
    for label, fn in (("index_add_", index_add), ("sorted", sorted_sum),
                      ("index_put_", index_put), ("index_put_", index_put),
                      ("sorted", sorted_sum), ("index_add_", index_add)):
        times[label].append(round(cuda_ms(fn, iters=5, warmup=1), 5))
    runs = [sorted_sum() for _ in range(3)]
    same = all(torch.equal(runs[0], r) for r in runs[1:])
    adds = [index_add() for _ in range(3)]
    log(f"  seg_sum2 at a merge's shape ({live} rows of a 2^21 buffer into "
        f"{groups} groups, one double slot), ms a call in turns: "
        f"index_add_ {times['index_add_']}, sorted {times['sorted']}, "
        f"index_put_ accumulate {times['index_put_']}; the "
        f"sorted form gives the same bits in 3 runs: {same}; index_add_ "
        f"does: {all(torch.equal(adds[0], a) for a in adds[1:])}; largest "
        f"difference {float((runs[0] - adds[0]).abs().max()):.3e}")
    if not same:
        raise AssertionError("seg_sum2 gave other bits on a rerun")


# --------------------------------------------------------------------------
# phase 3o: the DataFrame and session API leftovers on the card
# --------------------------------------------------------------------------

#: the seeds of phase 3o's rand(), randomSplit and sample
API_RAND_SEED = 11
API_SPLIT_SEED = 7
API_SAMPLE_SEED = 3
API_SAMPLE_FRACTION = 0.1
#: the money columns phase 3o describes, summarizes and unpivots
API_MONEY = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
#: percentages of phase 3o's percentile_approx and approxQuantile
API_PCTS = [0.25, 0.5, 0.75]
#: the t-digest's delta at Spark's default accuracy 10000
#: (``ops/tdigest.py`` ``delta_for_accuracy``)
API_DELTA = 200
#: the rank error allowed against the exact percentile, plus one row: the
#: largest centroid's share of its group (at p = 0.5 under the k1 scale),
#: pi / delta = 0.0157.  An estimate between two of l_quantity's tied
#: values (2% of the rows each) ranks at most 1% from p, inside it
API_RANK_ERR = np.pi / API_DELTA
STRATEGY_KEY = "spark.rapids.sql.approxPercentile.strategy"


# --------------------------------------------------------------------------
# phase 2: the string kernels (md5, dtoa_shortest, the DFA walk)
# --------------------------------------------------------------------------

#: md5 row lengths at the edges of RFC 1321's padding: one block up to 55
#: bytes, two from 56, three from 120
MD5_EDGE_LENS = (0, 55, 56, 63, 64, 119, 120)


def string_rows(rng, lens, width: int, alphabet=None):
    """A uint8 [rows, width] matrix and int32 lengths: each row ``lens[i]``
    bytes drawn from ``alphabet`` (default: every byte), zeros after."""
    lens = np.asarray(lens, dtype=np.int32)
    if alphabet is None:
        chars = rng.integers(0, 256, (lens.size, width), dtype=np.uint8)
    else:
        a = np.frombuffer(alphabet, dtype=np.uint8)
        chars = a[rng.integers(0, a.size, (lens.size, width))]
    chars[np.arange(width)[None] >= lens[:, None]] = 0
    return chars, lens


#: check_md5's batch with rows that are not valid: its capacity, and its
#: live rows (no multiple of 256, so a block's rows part at the dead tail)
MD5_VALID_CHECK = (1 << 17, 100_003)


def check_md5(K, torch) -> float:
    """md5 kernel vs plain on the card, byte for byte, and vs hashlib on
    the host: the edge lengths at widths 128 (aligned words) and 130 (byte
    reads), a row of the full width, and o_comment's shape (1,500,000 rows
    of up to 32 bytes), every row valid; then a batch of
    :data:`MD5_VALID_CHECK` rows at width 64 and at 130 with ``valid``: a
    dead tail past its live rows and nulls among them, each with bytes and
    a length (the kernel must not hash them: 32 zero bytes).  Returns the
    max abs error (0.0)."""
    import hashlib
    rng = np.random.default_rng(SEED + 16)
    cap, live = MD5_VALID_CHECK
    cases = [(list(MD5_EDGE_LENS) + [1, 128], 128, False),
             (list(MD5_EDGE_LENS) + [130], 130, False),
             (rng.integers(0, 33, 1_500_000), 32, False),
             (rng.integers(0, 65, cap), 64, True),
             (rng.integers(0, 131, cap), 130, True)]
    for lens, width, with_valid in cases:
        chars, lens = string_rows(rng, lens, width)
        c, n = torch.from_numpy(chars).cuda(), torch.from_numpy(lens).cuda()
        ok = np.ones(lens.size, dtype=bool)
        if with_valid:
            ok[live:] = False
            ok[rng.random(lens.size) < 0.05] = False
        v = torch.from_numpy(ok).cuda() if with_valid else None
        a = K.md5(c, n, v)
        b = K.md5_plain(c, n, v)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"md5 width {width}: kernel != plain")
        got = a.cpu().numpy()
        if got[~ok].any():
            raise AssertionError(f"md5 width {width}: a row that is not "
                                 "valid is not 32 zero bytes")
        checked = np.flatnonzero(ok)[:200]
        if with_valid:   # and the valid rows beside the dead tail
            checked = np.concatenate([checked, np.arange(live - 40, live)])
        for r in checked[ok[checked]]:
            want = hashlib.md5(bytes(chars[r, :lens[r]])).hexdigest()
            if bytes(got[r]).decode() != want:
                raise AssertionError(f"md5 row of {lens[r]} bytes: "
                                     f"{bytes(got[r])} != hashlib {want}")
        log(f"  md5 {lens.size} rows at width {width}"
            + (f", {int(ok.sum())} valid" if with_valid else "")
            + f": kernel == plain, {int(ok[checked].sum())} valid rows == "
            "hashlib" + (", the rest 32 zero bytes" if with_valid else ""))
    return 0.0


def trailing_zero_values(seed: int, per: int = 4096):
    """(doubles, their digits, their exponents): ``per`` doubles of each
    count of significant digits from 1 to 17, read from decimal text with
    exponents in [-20, 20], so that Schubfach's 16 or 17 digits end in 0 to
    16 zeros before the strip; each row's digits (no trailing zero) and
    exponent as written, which are the shortest up to 15 digits."""
    import random
    rng = random.Random(seed)
    digits, exps = [], []
    for places in range(1, 18):
        for _ in range(per):
            m = rng.randrange(10 ** (places - 1), 10 ** places)
            digits.append(m + 1 if m % 10 == 0 else m)
            exps.append(rng.randint(-20, 20))
    vals = np.array([float(f"{m}e{x}") for m, x in zip(digits, exps)])
    return vals, np.array(digits, dtype=np.int64), np.array(exps)


def check_dtoa(K, torch) -> float:
    """dtoa_shortest kernel vs plain on the card (digits, exponents and
    sides equal) at the edges (``testing.java_text.dtoa_edges``), over
    2^21 random
    double bit patterns and 2^21 random float bit patterns, over a
    partition of l_extendedprice's money (1,500,000 doubles of two
    decimals), and over doubles of 1 to 17 significant digits and their
    floats (:func:`trailing_zero_values`: 16 to 0 zeros stripped; the
    doubles' digits and exponents as written, up to 15 digits);
    the edges also against Java's strings on the host (``java_double``
    and ``java_float``).  Returns the max abs error of the digits
    (0)."""
    from spark_rapids_tpu_torch.ops import cast_strings as CS
    from spark_rapids_tpu_torch.testing.java_text import (
        dtoa_edges, java_double, java_float)
    rng = np.random.default_rng(SEED + 17)
    d_edge, f_edge = dtoa_edges()
    cases = [("edges f64", d_edge), ("edges f32", f_edge),
             ("random f64 bits", rng.integers(-(1 << 63), (1 << 63) - 1,
                                              1 << 21, dtype=np.int64)
              .view(np.float64)),
             ("random f32 bits", rng.integers(-(1 << 31), (1 << 31) - 1,
                                              1 << 21, dtype=np.int64)
              .astype(np.int32).view(np.float32)),
             ("money", np.round(rng.random(1_500_000) * 104949 + 901, 2))]
    zv, zd, ze = trailing_zero_values(SEED + 170)
    cases += [("0-16 trailing zeros f64", zv),
              ("0-16 trailing zeros f32", zv.astype(np.float32))]
    for label, vals in cases:
        x = torch.from_numpy(np.ascontiguousarray(vals)).cuda()
        a = K.dtoa_shortest(x)
        b = K.dtoa_plain(x)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            raise AssertionError(f"dtoa {label}: kernel != plain")
        log(f"  dtoa_shortest {label}, {vals.size} values: kernel == plain")
        if label == "0-16 trailing zeros f64":
            exact = np.repeat(np.arange(1, 18), zv.size // 17) <= 15
            got_d, got_e = a[0].cpu().numpy(), a[1].cpu().numpy()
            if not (np.array_equal(got_d[exact], zd[exact])
                    and np.array_equal(got_e[exact], ze[exact])):
                raise AssertionError("dtoa: digits or exponents of up to 15 "
                                     "places differ from their text")
    for vals, oracle in ((d_edge, java_double), (f_edge, java_float)):
        x = torch.from_numpy(vals).cuda()
        chars, lens = CS.format_java_float(x, *K.dtoa_shortest(x)[:2])
        chars, lens = chars.cpu().numpy(), lens.cpu().numpy()
        for i, v in enumerate(vals):
            got = bytes(chars[i, :lens[i]]).decode()
            if got != oracle(v):
                raise AssertionError(f"dtoa {v!r}: {got} != Java's "
                                     f"{oracle(v)}")
    log(f"  dtoa_shortest: {d_edge.size + f_edge.size} edge values give "
        "Java's Double.toString and Float.toString text")
    return 0.0


def dfa_cases():
    """(label, pattern, search) of the DFA checks: anchors at both ends,
    classes, alternation, repetition and one the JAX package's own tests
    use."""
    return [("special.*requests", True), ("^[0-9]+", False),
            ("[0-9]+$", False), ("^ab", True), ("cd$", True),
            ("a[bc]*d", False),
            (" ", False), ("(ab)+", False), ("x?", False),
            ("[a-z]{2,4}[0-9]", False), ("^$", True)]


#: check_dfa's widths: the regexp items' (16, 64), the tile path's edges
#: (1, 17, 33, 65, 200: odd widths stage byte by byte) and the warp path's
#: (300: rows wider than the span kernel's tile takes)
DFA_CHECK_WIDTHS = (1, 16, 17, 33, 64, 65, 200, 300)
#: rows a width: no multiple of a tile or a warp, so the last tile is cut
DFA_CHECK_ROWS = 4133


def check_dfa(K, torch) -> float:
    """dfa_search and dfa_match_spans kernels vs plain on the card, equal,
    at each of :data:`DFA_CHECK_WIDTHS` over :data:`DFA_CHECK_ROWS` rows of
    0 to ``width`` bytes (empty rows and rows of the full width among them)
    for each of :func:`dfa_cases`, and over a synthetic table of 255 states
    and 200 classes (65,535 bytes, and the search's fused table 130,560
    bytes: dynamic shared memory); the span
    kernel's paths (the shared-memory tile, a warp a row) are each taken at
    some width, each also from rows that start one byte off 16 (staged
    byte by byte).  Returns 0.0."""
    from spark_rapids_tpu_torch.ops import regex_engine as RX
    rng = np.random.default_rng(SEED + 18)
    tables = []
    for pattern, search in dfa_cases():
        rx = RX.compile_regex(pattern, search_prefix=search,
                              extent_exact=not search)
        tables.append((pattern, K.dfa_tables(rx, "cuda")))
    states, classes = 255, 200
    # a random table whose last state is dead, as the compiler's is: it
    # goes only to itself and accepts nothing (the kernels stop there)
    table = rng.integers(0, states, (states, classes), dtype=np.uint8)
    table[states - 1] = states - 1
    accept = (rng.random(states) < 0.05).astype(np.uint8)
    accept[states - 1] = 0
    synth = dict(
        table=torch.from_numpy(table).cuda(),
        cls=torch.from_numpy(rng.integers(0, classes, 256, dtype=np.uint8)
                             ).cuda(),
        accept=torch.from_numpy(accept).cuda(),
        states=states, classes=classes, start=0, dead=states - 1,
        anchored_start=False, anchored_end=False)
    # the search kernel's table: 130,560 bytes of shared memory
    synth["fused"] = K.dfa_fused(synth["table"], synth["cls"],
                                 synth["accept"])
    tables.append(("255 states x 200 classes", synth))
    paths = {}
    for width in DFA_CHECK_WIDTHS:
        lens = rng.integers(0, width + 1, DFA_CHECK_ROWS)
        lens[:8] = [0, 0, width, width, min(1, width), min(2, width),
                    min(3, width), width - 1]
        chars, lens = string_rows(rng, lens, width,
                                  b"abcdxyz0123456789 special requests")
        c, n = torch.from_numpy(chars).cuda(), torch.from_numpy(lens).cuda()
        # the same rows one byte off 16: every width stages byte by byte
        buf = torch.empty(c.numel() + 1, dtype=torch.uint8, device="cuda")
        buf[1:] = c.reshape(-1)
        inputs = [(c, n), (buf[1:].view(c.shape), n)]
        found = {0: 0, 1: 0}
        for label, dfa in tables:
            for anchored_end in ((False, True) if "states" in label else
                                 (dfa["anchored_end"],)):
                dfa = dict(dfa, anchored_end=anchored_end)
                path = K.dfa_spans_path(dfa, width)
                paths.setdefault(path, set()).add(width)
                for ci, ni in inputs:
                    a = K.dfa_search(dfa, ci, ni)
                    b = K.dfa_search_plain(dfa, ci, ni)
                    sa = K.dfa_match_spans(dfa, ci, ni)
                    sb = K.dfa_match_spans_plain(dfa, ci, ni)
                    torch.cuda.synchronize()
                    if not torch.equal(a, b):
                        raise AssertionError(f"dfa_search {label!r} width "
                                             f"{width}: kernel != plain")
                    if not (torch.equal(sa[0], sb[0])
                            and torch.equal(sa[1], sb[1])):
                        raise AssertionError(
                            f"dfa_match_spans {label!r} width {width} (path "
                            f"{path}, {ci.shape[0]} rows): kernel != plain")
                found[0] += int(a.sum())
                found[1] += int(sa[0].sum())
        log(f"  dfa width {width}, {lens.size} rows (and one byte off): "
            f"{len(tables) + 1} tables, span path(s) "
            f"{sorted(p for p, w in paths.items() if width in w)}; search "
            f"{found[0]} hits, {found[1]} spans; kernel == plain")
    # the default build tiles rows up to 254 bytes and walks wider ones a
    # warp a row: both paths must have run
    dfa = tables[0][1]
    want = {K.dfa_spans_path(dfa, 64), K.dfa_spans_path(dfa, 300)}
    if not want <= set(paths):
        raise AssertionError(f"dfa_match_spans: paths {sorted(paths)} run, "
                             f"{sorted(want)} expected")
    log(f"  dfa_match_spans paths by width: "
        f"{ {p: sorted(w) for p, w in sorted(paths.items())} } "
        "(0 the shared-memory tile, 1 a warp a row)")
    return 0.0


def check_pcg64(K, torch) -> float:
    """pcg64_uniform kernel vs plain (numpy's stream) on the card, bit for
    bit, at rand()'s shapes (a partition of phase 3o: 2^21 draws), at the
    edges of a thread's rows and of the build's block tile (n = 1, a tile
    less one, a tile, a tile and one, two tiles and one, from offsets on
    and beside a tile boundary), and over 2^24 + 3 draws (8,193 blocks, so
    that 14 bits of the block index jump); returns the max abs error seen
    (0.0)."""
    lib = K._lib("pcg64")
    tile = lib.pcg64_stride() * lib.pcg64_rows_per_thread()
    edges = [((API_RAND_SEED << 16) ^ p, offset, n)
             for p, offset in enumerate((0, tile, 5 * tile - 1,
                                         (1 << 40) + 5))
             for n in (1, tile - 1, tile, tile + 1, 2 * tile + 1)]
    worst = 0.0
    for seed, offset, n in [(API_RAND_SEED << 16, 0, 1 << 21),
                            ((API_RAND_SEED << 16) ^ 3, 1_500_000, 1 << 21),
                            (12345, 0, 0), (12345, 0, 1), (12345, 5, 255),
                            (12345, 5, 256), (12345, 7, 2049),
                            (1 << 40, (1 << 40) + 3, 100_003),
                            (7, 3 * tile, (1 << 24) + 3)] + edges:
        state, inc = K.pcg64_seeded(seed)
        a = K.pcg64_uniform(state, inc, offset, n, "cuda")
        b = K.pcg64_uniform_plain(state, inc, offset, n, "cuda")
        torch.cuda.synchronize()
        err = float((a - b).abs().max()) if n else 0.0
        worst = max(worst, err)
        log(f"  pcg64 seed={seed} offset={offset} n={n}: max_abs_err={err}")
        if a.dtype != torch.float64 or not torch.equal(a, b):
            raise AssertionError(f"pcg64 seed={seed} offset={offset} n={n}: "
                                 "kernel != numpy's stream")
    return worst


def _lineitem_partitions(n: int, parts: int = 4):
    """[lo, hi) of each partition of an n-row relation at ``parts``
    partitions (the port's contiguous split)."""
    per = -(-n // parts)
    return [(min(p * per, n), min((p + 1) * per, n)) for p in range(parts)]


def _stream(seed: int, pid: int, n: int):
    """rand(seed)'s draws for a partition of n rows: numpy's own stream."""
    return np.random.Generator(np.random.PCG64((seed << 16) ^ pid)).random(n)


def _close(got, want, label: str, rtol: float = RTOL_F64) -> None:
    if not np.allclose(got, want, rtol=rtol, atol=0.0):
        raise AssertionError(f"{label}: {got} vs numpy {want} (rtol {rtol})")


def _rank_ok(sorted_vals, est, p, label: str) -> float:
    """The estimate's rank in the sorted values is within the digest's
    rank error of p: its rank is an interval where values tie (the money
    columns take few values), and an estimate within RTOL_F64 of a value
    (a mean of tied values, summed) counts as that value.  Returns the
    rank error."""
    slack = abs(est) * RTOL_F64
    lo = np.searchsorted(sorted_vals, est - slack, "left") / sorted_vals.size
    hi = np.searchsorted(sorted_vals, est + slack, "right") / sorted_vals.size
    err = 0.0 if lo <= p <= hi else min(abs(p - lo), abs(p - hi))
    if err >= API_RANK_ERR + 1.0 / sorted_vals.size:
        raise AssertionError(f"{label}: p={p} estimate {est} has rank error "
                             f"{err:.5f}")
    return err


def api_phase(srt, K, torch, tpch, fact, root: str, by_path, err) -> dict:
    """Phase 3o: the DataFrame and session API leftovers through the
    normal entry points over the SF1 lineitem and the rig's 3M-row fact
    table, each driven with its launches counted and held against numpy:
    pivot, describe, summary, percentile_approx by the two flags (the
    t-digest), approxQuantile (exact), crosstab, corr and cov, na over the
    fact table's nullable columns, dropDuplicates, unpivot, randomSplit,
    sample, rand, spark_partition_id, monotonically_increasing_id and
    input_file_name over phase 3m's files of the fact table.  Returns each
    item's run (with its pcg64 calls) for phase 4, and the launches."""
    from spark_rapids_tpu_torch.io_ import parquet_meta as M
    from spark_rapids_tpu_torch.io_.registry import expand_paths
    from spark_rapids_tpu_torch.sql import functions as F
    li = tpch["lineitem"]
    n = li["l_quantity"].size
    phase("3o", f"the DataFrame and session API leftovers over the SF1 "
          f"lineitem ({n} rows) and the rig's fact table "
          f"({len(fact['q'])} rows), 4 partitions each")
    sess = srt.session()
    cols = ["l_orderkey", "l_partkey", "l_returnflag", "l_linestatus"] + \
        list(API_MONEY)
    ldf = sess.create_dataframe({c: li[c] for c in cols}, num_partitions=4)
    fdf = sess.create_dataframe(fact, num_partitions=4)
    book: dict = {}
    runs = {}

    def run(label, fn, must=()):
        calls: list = []
        with recording(K, "pcg64_uniform", calls,
                       lambda a: torch.device(a[-1]).type == "cuda"):
            out, launches, secs = drive(f"api {label}", fn, K, torch, must,
                                        book)
        runs[label] = dict(fn=fn, cold_s=secs, launches=launches,
                           pcg64=calls)
        return out

    flags = np.char.add(li["l_returnflag"].astype("U1"),
                        li["l_linestatus"].astype("U1"))
    keys, inv = np.unique(flags, return_inverse=True)

    # pivot: sum(l_quantity) by returnflag x linestatus (integer-valued
    # doubles: exact)
    piv = ldf.groupBy("l_returnflag").pivot("l_linestatus").sum(
        "l_quantity").orderBy("l_returnflag")
    t = run("pivot", piv.collect, ("seg_sum_f32",))
    sums = np.bincount(inv, weights=li["l_quantity"], minlength=keys.size)
    for row in t.to_pylist():
        for status in ("F", "O"):
            want = sums[np.searchsorted(keys, row["l_returnflag"] + status)]
            if row[status] != want:
                raise AssertionError(f"pivot {row}: {status} != {want}")
    log(f"  pivot: {t.num_rows} rows x {t.column_names}, exact")

    # describe and summary of the money columns (count, min, max exact;
    # mean and stddev within RTOL_F64; the 6M-row percentiles by the
    # t-digest, 'auto' at this size, within its rank error)
    from spark_rapids_tpu_torch.ops.tdigest import delta_for_accuracy
    if delta_for_accuracy(10000) != API_DELTA:
        raise AssertionError(f"the digest's delta at accuracy 10000 is "
                             f"{delta_for_accuracy(10000)}, not {API_DELTA}")
    money = ldf.select(*API_MONEY)
    sorted_money = {c: np.sort(li[c]) for c in API_MONEY}
    worst = 0.0
    for label, fn in (("describe", money.describe), ("summary",
                                                     money.summary)):
        t = run(label, lambda fn=fn: fn().collect(), ("seg_sum_f32",))
        for row in t.to_pylist():
            stat = row["summary"]
            for c in API_MONEY:
                got, x = float(row[c]), li[c]
                if stat == "count":
                    ok = got == x.size
                elif stat in ("min", "max"):
                    ok = got == getattr(x, stat)()
                elif stat == "mean":
                    ok = np.isclose(got, x.mean(), rtol=RTOL_F64, atol=0)
                elif stat == "stddev":
                    ok = np.isclose(got, x.std(ddof=1), rtol=RTOL_F64,
                                    atol=0)
                else:
                    worst = max(worst, _rank_ok(
                        sorted_money[c], got, float(stat[:-1]) / 100,
                        f"{label} {c} {stat}"))
                    ok = True
                if not ok:
                    raise AssertionError(f"{label} {c} {stat}: {got}")
        log(f"  {label}: {t.num_rows} statistics x {len(API_MONEY)} columns "
            f"match numpy (worst rank error {worst})")

    # percentile_approx by the two flags, the t-digest strategy
    tsess = srt.session(conf={STRATEGY_KEY: "tdigest"})
    tdf = tsess.create_dataframe({c: li[c] for c in cols}, num_partitions=4)
    pq_ = tdf.groupBy("l_returnflag", "l_linestatus").agg(
        F.percentile_approx("l_extendedprice", API_PCTS).alias("p"),
        F.count("*").alias("n"))
    t = run("percentile_approx", pq_.collect, ("seg_sum_f32",))
    worst = 0.0
    for row in t.to_pylist():
        g = np.searchsorted(keys, row["l_returnflag"] + row["l_linestatus"])
        vals = np.sort(li["l_extendedprice"][inv == g])
        if row["n"] != vals.size:
            raise AssertionError(f"percentile_approx {row}: count")
        for est, p in zip(row["p"], API_PCTS):
            worst = max(worst, _rank_ok(
                vals, est, p, f"percentile_approx {row['l_returnflag']}"
                f"{row['l_linestatus']}"))
    log(f"  percentile_approx: {t.num_rows} groups, every percentile "
        f"within rank error {API_RANK_ERR:.5f} + 1/n of numpy's (worst "
        f"{worst})")

    # approxQuantile under the exact strategy: Spark's percentile ordinal
    esess = srt.session(conf={STRATEGY_KEY: "exact"})
    edf = esess.create_dataframe({"l_extendedprice": li["l_extendedprice"]},
                                 num_partitions=4)
    got = run("approxQuantile",
              lambda: edf.approxQuantile("l_extendedprice", API_PCTS))
    xs = sorted_money["l_extendedprice"]
    want = [xs[max(int(np.ceil(p * xs.size)) - 1, 0)] for p in API_PCTS]
    if got != want:
        raise AssertionError(f"approxQuantile {got} vs numpy {want}")
    log(f"  approxQuantile (exact): {got}, numpy's ordinals")

    # crosstab: the pair counts, exact
    t = run("crosstab", ldf.crosstab("l_returnflag", "l_linestatus").collect,
            ("seg_sum_f32",))
    counts = np.bincount(inv, minlength=keys.size)
    for row in t.to_pylist():
        for status in ("F", "O"):
            want = counts[np.searchsorted(keys,
                                          row["l_returnflag_l_linestatus"]
                                          + status)]
            if row[status] != want:
                raise AssertionError(f"crosstab {row}: {status} != {want}")
    log(f"  crosstab: {t.num_rows} x {t.column_names}, exact")

    # corr and cov of quantity and price (correlated: the one-pass formula
    # cancels little)
    got = run("corr_cov", lambda: (ldf.corr("l_quantity", "l_extendedprice"),
                                   ldf.cov("l_quantity", "l_extendedprice")),
              ("seg_sum_f64",))
    x, y = li["l_quantity"], li["l_extendedprice"]
    _close(np.array(got), [np.corrcoef(x, y)[0, 1], np.cov(x, y)[0, 1]],
           "corr, cov")
    log(f"  corr, cov: {got} (numpy within rtol {RTOL_F64})")

    # na over the fact table's nullable columns (v double, s string)
    v_ok = ~np.ma.getmaskarray(fact["v"])
    s_ok = ~np.ma.getmaskarray(fact["s"])
    s_data = np.ma.getdata(fact["s"])
    q = np.ma.getdata(fact["q"]).astype(np.int64)
    got = run("na", lambda: (
        fdf.dropna(subset=["v", "s"]).count(),
        fdf.na.fill({"s": "none"}).filter(F.col("s") == "none").count(),
        fdf.na.drop("all", subset=["v", "s"]).count(),
        fdf.replace(0, 1000, subset=["q"]).agg(F.sum("q")).collect()
        .to_pylist()[0]["sum(q)"]), ("seg_sum_f32",))
    want = (int((v_ok & s_ok).sum()),
            int((~s_ok).sum() + (s_ok & (s_data == "none")).sum()),
            int((v_ok | s_ok).sum()),
            int(np.where(q == 0, 1000, q).sum()))
    if tuple(got) != want:
        raise AssertionError(f"na: {got} vs numpy {want}")
    log(f"  na: dropna, fill, drop('all'), replace: {got}, exact")

    # dropDuplicates by the fact table's key over 4 partitions (a hash
    # exchange of the partial rows)
    t = run("dropDuplicates", fdf.dropDuplicates(["k"]).select("k", "q")
            .collect, ("murmur3_long",))
    ks = np.ma.getdata(t.column("k"))
    if not np.array_equal(np.sort(ks), np.unique(fact["k"])):
        raise AssertionError("dropDuplicates: keys differ from numpy's")
    log(f"  dropDuplicates(k): {t.num_rows} rows, one per key")

    # unpivot of the money columns, then each column's sum
    up = ldf.select("l_orderkey", *API_MONEY).unpivot(
        "l_orderkey", list(API_MONEY), "col", "val").groupBy("col").agg(
        F.sum("val").alias("s"), F.count("*").alias("n"))
    t = run("unpivot", up.collect, ("seg_sum_f64",))
    got = {r["col"]: (r["s"], r["n"]) for r in t.to_pylist()}
    for c in API_MONEY:
        _close(np.array([got[c][0]]), [li[c].sum()], f"unpivot {c}")
        if got[c][1] != n:
            raise AssertionError(f"unpivot {c}: {got[c][1]} rows")
    log(f"  unpivot: {len(got)} columns x {n} rows, sums within "
        f"rtol {RTOL_F64}")

    # randomSplit([0.8, 0.2], 7): each partition's rows go by numpy's stream
    bounds = _lineitem_partitions(n)
    a, b = ldf.randomSplit([0.8, 0.2], API_SPLIT_SEED)
    ta, tb = run("randomSplit", lambda: (
        a.select("l_orderkey", "l_extendedprice").collect(),
        b.select("l_orderkey", "l_extendedprice").collect()), ("pcg64",))
    u = np.concatenate([_stream(API_SPLIT_SEED, p, hi - lo)
                        for p, (lo, hi) in enumerate(bounds)])
    first = u < 0.8
    for label, t, sel in (("0.8", ta, first), ("0.2", tb, ~first)):
        for c in ("l_orderkey", "l_extendedprice"):
            if not np.array_equal(np.ma.getdata(t.column(c)), li[c][sel]):
                raise AssertionError(f"randomSplit {label}: {c} differs from "
                                     "numpy's stream")
    if ta.num_rows + tb.num_rows != n:
        raise AssertionError("randomSplit: rows lost or repeated")
    log(f"  randomSplit: {ta.num_rows} + {tb.num_rows} = {n} rows, disjoint, "
        "each row where numpy's stream puts it")

    # sample(0.1, 3): within 5 sigma of the binomial, and the host stream's
    # rows
    t = run("sample", ldf.sample(API_SAMPLE_FRACTION, API_SAMPLE_SEED)
            .select("l_orderkey", "l_extendedprice").collect)
    sigma = np.sqrt(n * API_SAMPLE_FRACTION * (1 - API_SAMPLE_FRACTION))
    if abs(t.num_rows - n * API_SAMPLE_FRACTION) > 5 * sigma:
        raise AssertionError(f"sample: {t.num_rows} rows of {n}")
    # SampleExec draws a batch's capacity; its first rows' draws are these
    keep = np.concatenate([
        np.random.default_rng(API_SAMPLE_SEED + p * 1000003).random(hi - lo)
        < API_SAMPLE_FRACTION for p, (lo, hi) in enumerate(bounds)])
    if not np.array_equal(np.ma.getdata(t.column("l_extendedprice")),
                          li["l_extendedprice"][keep]):
        raise AssertionError("sample: rows differ from the host stream's")
    log(f"  sample: {t.num_rows} rows (expected {n * API_SAMPLE_FRACTION:.0f}"
        f" +- {5 * sigma:.0f}), the host stream's rows")

    # rand(11), spark_partition_id, monotonically_increasing_id
    t = run("rand_ids", ldf.select(
        F.spark_partition_id().alias("p"),
        F.monotonically_increasing_id().alias("m"),
        F.rand(API_RAND_SEED).alias("r")).collect, ("pcg64",))
    pid = np.concatenate([np.full(hi - lo, p) for p, (lo, hi)
                          in enumerate(bounds)])
    pos = np.concatenate([np.arange(hi - lo) for lo, hi in bounds])
    r = np.concatenate([_stream(API_RAND_SEED, p, hi - lo)
                        for p, (lo, hi) in enumerate(bounds)])
    if not (np.array_equal(np.ma.getdata(t.column("p")), pid)
            and np.array_equal(np.ma.getdata(t.column("m")),
                               (pid.astype(np.int64) << 33) + pos)
            and np.array_equal(np.ma.getdata(t.column("r")), r)):
        raise AssertionError("rand / spark_partition_id / "
                             "monotonically_increasing_id differ")
    log(f"  rand({API_RAND_SEED}): {n} draws bit for bit numpy's "
        "PCG64((seed << 16) ^ partition) stream on every partition; "
        "partition ids and monotonic ids exact")

    # input_file_name() over phase 3m's files of the fact table
    path = os.path.join(root, "fact")
    files = expand_paths([path])
    want = {f: M.read_footer(f).num_rows for f in files}
    t = run("input_file_name", sess.read.parquet(path).select(
        F.input_file_name().alias("f")).groupBy("f").count().collect,
        ("seg_sum_f32",))
    got = {r["f"]: r["count"] for r in t.to_pylist()}
    if got != want:
        raise AssertionError(f"input_file_name: {got} vs footers {want}")
    log(f"  input_file_name: {len(got)} files, each with its footer's rows")

    total = {k: sum(b[k] for b in book.values()) for k in K.LAUNCHES}
    by_path.update({f"api {k}": v for k, v in book.items()})
    log(f"  phase 3o's launches of the hand kernels: {total}")
    for k in ("seg_sum_f32", "murmur3_long", "pcg64"):
        if total[k] < 1:
            raise AssertionError(f"phase 3o launched no {k}")
    return {"runs": runs, "launches": total}


def api_times(api: dict, K, torch) -> dict:
    """Phase 4's part for phase 3o: each item warm (one run after the cold
    one) and profiled once, and the pcg64 kernel against its plain version and its bound at
    the shapes of phase 3o's rand (each launch after an L2 flush), and back
    to back at 2^21 draws a launch (``b2b_ms``)."""
    report = []
    for label, rr in api["runs"].items():
        t0 = time.perf_counter()
        rr["fn"]()
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        prof = profile_query(f"api {label}", Collecting(rr["fn"]), torch,
                             top=6, detail=False)
        report.append({"item": label, "cold_ms": rr["cold_s"] * 1e3,
                       "warm_ms": warm, "profiled_wall_ms": prof["wall_ms"],
                       "busy_ms": prof["busy_ms"],
                       "busy_share": prof["busy_ms"] / prof["wall_ms"],
                       "launches": {k: rr["launches"][k]
                                    for k in RIG_KERNELS + ("pcg64",)}})
    log(json.dumps({"api": report}))
    calls = api["runs"]["rand_ids"]["pcg64"]
    ms = plain = bound = 0.0
    for state, inc, offset, n, _ in calls:
        ms += cuda_ms(lambda: K.pcg64_uniform(state, inc, offset, n, "cuda"),
                      flush_l2=True)
        plain += cuda_ms(lambda: K.pcg64_uniform_plain(state, inc, offset, n,
                                                       "cuda"),
                         iters=3, warmup=1, flush_l2=True)
        bound += 8 * n / HBM_BYTES_PER_S * 1e3
    out = dict(ms=ms, plain_ms=plain, bound_ms=bound, launches=len(calls))
    log(f"  pcg64 per rand({API_RAND_SEED}) run over 4 partitions "
        f"({out['launches']} launches of {calls[0][3] if calls else 0} "
        f"draws, each after the flush): "
        + ", ".join(f"{k}={v:.5f}" for k, v in out.items())
        + f"; share of bound {bound / max(ms, 1e-12):.1%}; library_ms null: "
        "no torch call draws numpy's PCG64 stream")
    state, inc = K.pcg64_seeded(API_RAND_SEED << 16)
    n = 1 << 21
    out["b2b_ms"] = pcg64_back_to_back(
        torch, lambda offset, m: K.pcg64_uniform(state, inc, offset, m,
                                                 "cuda"), n)
    b2b_bound = 8 * n / HBM_BYTES_PER_S * 1e3
    lib = K._lib("pcg64")
    log(f"  pcg64 back to back, n=2^21, 256 launches, the last 8 outputs "
        f"live (128 MB), events around the run: {out['b2b_ms']:.5f} ms a "
        f"launch (bound {b2b_bound:.5f} ms, "
        f"{b2b_bound / out['b2b_ms']:.1%}); beside it each launch after "
        f"the flush {ms / max(len(calls), 1):.5f} ms "
        f"({bound / max(ms, 1e-12):.1%}); {lib.pcg64_stride()} threads x "
        f"{lib.pcg64_rows_per_thread()} rows a block")
    return out


# --------------------------------------------------------------------------
# phase 3p: md5, conv, format_number, doubles and floats as text, non-ASCII
# translate, and the regexp functions at SF1
# --------------------------------------------------------------------------

#: TPC-H's l_comment words (dbgen's text grammar draws from lists like
#: these): l_comment is made in phase 3p from 256 comments of 2 to 6 words
TPCH_WORDS = ["furiously", "quickly", "carefully", "blithely", "slyly",
              "ironic", "final", "regular", "express", "special", "pending",
              "bold", "even", "silent", "unusual", "deposits", "requests",
              "accounts", "packages", "instructions", "theodolites",
              "foxes", "pinto", "beans", "ideas", "dependencies", "asymptotes",
              "platelets", "sleep", "wake", "haggle", "nag", "use", "cajole",
              "detect", "integrate", "boost", "among", "above", "about"]
L_COMMENT_SEED = 161
#: the card's 32-bit integer operations a second: 132 SMs x 64 INT32 lanes
#: x 1.98 GHz (the H100 SXM's boost clock); the data sheet gives no integer
#: rate outside the tensor cores
INT_OPS_PER_S = 132 * 64 * 1.98e9
#: integer operations the bounds count: an MD5 block (the SASS of md5.cu's
#: 64 steps and four adds to the state on sm_90a, 293 instructions as
#: tools/strings_ab.py --mode md5_search counts them; 330, ~5 a step, before
#: that count), a double or float's shortest digits, a DFA step
MD5_OPS_PER_BLOCK = 293
DTOA_OPS = 150
DFA_OPS_PER_BYTE = 6
#: rows of phase 3p's slice of the rig's fact table held row by row to
#: Java's Double.toString and Float.toString (the oracles are Python per
#: value, and a background check holds the interpreter lock)
FLOAT_SLICE_ROWS = 50_000
#: TPC-H SF1's part rows: phase 3p splits and translates the first of the
#: generator's (rows // 8) parts
SF1_PARTS = 200_000
STRING_MATRIX_SEED = 1616
STRING_TAIL_KERNELS = ("md5", "dtoa_shortest", "dfa_search", "dfa_match_spans")
#: phase 3p's views' partitions: each evaluation of a kernel's expression
#: launches once a partition
STRING_PARTITIONS = 4
STRING_TAIL_SOURCES = {"md5": "md5", "dtoa_shortest": "dtoa",
                   "dfa_search": "regex_dfa", "dfa_match_spans": "regex_dfa"}
#: what each replaces (no Pallas kernel): the JAX package's host code or scan
STRING_TAIL_REPLACES = {
    "md5": "spark_rapids_tpu/sql/expressions/strings.py:770",
    "dtoa_shortest": "spark_rapids_tpu/sql/expressions/cast.py:413",
    "dfa_search": "spark_rapids_tpu/ops/regex_engine.py:625",
    "dfa_match_spans": "spark_rapids_tpu/ops/regex_engine.py:659"}


def make_l_comment(n: int, seed: int = L_COMMENT_SEED):
    """(l_comment of n rows as HostStrings, the 256 comments, each row's
    comment index): TPC-H-like comments of 2 to 6 words, 10 to 43 bytes,
    laid out in Arrow's form directly (a numpy str array of 6M rows takes
    seconds to encode)."""
    from spark_rapids_tpu_torch.columnar.convert import HostStrings
    rng = np.random.default_rng(seed)
    comments = []
    while len(comments) < 256:
        c = " ".join(rng.choice(TPCH_WORDS, rng.integers(2, 7)))
        if 10 <= len(c) <= 43:
            comments.append(c)
    idx = rng.integers(0, 256, n)
    table = np.zeros((256, 43), dtype=np.uint8)
    lens = np.array([len(c) for c in comments])
    for i, c in enumerate(comments):
        table[i, :len(c)] = np.frombuffer(c.encode(), dtype=np.uint8)
    row_lens = lens[idx]
    data = table[idx][np.arange(43)[None] < row_lens[:, None]]
    offsets = np.concatenate([[0], np.cumsum(row_lens)]).astype(np.int64)
    return HostStrings(offsets, data, np.ones(n, dtype=bool)), comments, idx


def check_string_tail_calls(K, torch, label: str, calls: dict) -> dict:
    """md5, dtoa_shortest, dfa_search and dfa_match_spans kernel vs plain,
    every output equal (dtoa's digits, exponents and sides; the spans'
    chosen starts and lengths), on every call that phase 3p's item
    ``label`` made, at its own inputs.  These launches come after the
    item's counts were read.  Returns each kernel's max abs error (0)."""
    plain = {"md5": K.md5_plain, "dtoa_shortest": K.dtoa_plain,
             "dfa_search": K.dfa_search_plain,
             "dfa_match_spans": K.dfa_match_spans_plain}
    worst = {}
    for name, made in calls.items():
        kernel = getattr(K, name)
        for args in made:
            a, b = kernel(*args), plain[name](*args)
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            torch.cuda.synchronize()
            err = max(float((x.long() - y.long()).abs().max())
                      if x.numel() else 0.0 for x, y in zip(a, b))
            worst[name] = max(worst.get(name, 0.0), err)
            if not all(x.dtype == y.dtype and torch.equal(x, y)
                       for x, y in zip(a, b)):
                shapes = [list(x.shape) for x in args
                          if isinstance(x, torch.Tensor)]
                raise AssertionError(f"{name} on 3p {label}'s inputs "
                                     f"{shapes}: kernel != plain")
    if worst:
        log(f"  3p {label}: " + ", ".join(
            f"{name} == plain on all {len(calls[name])} calls"
            for name in worst))
    return worst


def string_tail_work(name: str, calls: list, lens=None,
                     values: int = 0) -> tuple:
    """(bytes, integer operations) that ``calls`` of kernel ``name`` must
    do for an item's live rows: ``lens``, the byte lengths of the item's
    input rows (numpy), for the string kernels, or ``values``, its count
    of doubles or floats, for dtoa_shortest, each times the evaluations a
    row (the calls over the partitions).  Padded rows are not counted;
    each input byte is read once and each output byte written once."""
    evals, rest = divmod(len(calls), STRING_PARTITIONS)
    if rest or not evals:
        raise AssertionError(f"{name}: {len(calls)} calls over "
                             f"{STRING_PARTITIONS} partitions")
    if name == "dtoa_shortest":
        # digits int64, exponent int32 and side int8 out
        size = calls[0][0].element_size()
        return (evals * values * (size + 13),
                evals * values * DTOA_OPS)
    rows, walked = lens.size, int(lens.sum())
    if name == "md5":
        blocks = int(((lens + 8) // 64 + 1).sum())
        return (evals * (walked + 4 * rows + 32 * rows),
                evals * blocks * MD5_OPS_PER_BLOCK)
    # dfa_search writes a bool a row; dfa_match_spans a bool and an int32
    # at each of the width + 1 starts
    width = calls[0][1].shape[1]
    out = 1 if name == "dfa_search" else 5 * (width + 1)
    return (evals * (walked + 4 * rows + out * rows),
            evals * walked * DFA_OPS_PER_BYTE)


def _group_of(keys) -> dict:
    """Each distinct key's count."""
    uk, counts = np.unique(keys, return_counts=True)
    return dict(zip(uk.tolist(), counts.tolist()))


def strings_phase(srt, K, torch, tpch, fact, by_path, err) -> dict:
    """Phase 3p: this slice's functions at full size over phase 3g's SF1
    TPC-H tables (4 partitions) and a slice of the rig's fact table, each
    driven with its launches counted and held exactly against a Python
    oracle (re, hashlib, Java's formats): an RLIKE count over o_comment,
    regexp_replace over l_comment by l_returnflag, regexp_extract of
    c_phone's country code, split(p_name, ' '), md5(o_comment), the
    doubles of l_extendedprice and a float column as text, q1's sums through
    format_number, conv of o_orderkey to hex, and translate(p_name, 'ae',
    'äé'); then the same functions on cuda and on the cpu over 262,144
    rows.  Returns each item's run and its kernels' calls for phase 4."""
    import hashlib
    import re
    from spark_rapids_tpu_torch.testing.java_text import (
        java_double, java_float, java_format_number)
    li, od, cu, pa_ = (tpch[k] for k in ("lineitem", "orders", "customer",
                                         "part"))
    n = li["l_quantity"].size
    phase("3p", f"md5, conv, format_number, doubles as text, translate and "
          f"the regexp functions over the SF1 tables ({n} lineitem rows), "
          "4 partitions")
    # the matrix's cpu side runs beside the items on the card
    started = start_string_tail_matrix_cpu(srt)
    t0 = time.perf_counter()
    l_comment, comments, cidx = make_l_comment(n)
    sess = srt.session()
    sess.create_dataframe(
        {"l_returnflag": li["l_returnflag"], "l_linestatus":
         li["l_linestatus"], "l_extendedprice": li["l_extendedprice"],
         "l_quantity": li["l_quantity"], "l_shipdate": li["l_shipdate"],
         "l_comment": l_comment}, num_partitions=4
    ).createOrReplaceTempView("lineitem")
    sess.create_dataframe({k: od[k] for k in ("o_orderkey", "o_comment")},
                          num_partitions=4).createOrReplaceTempView("orders")
    sess.create_dataframe({"c_phone": cu["c_phone"]}, num_partitions=4
                          ).createOrReplaceTempView("customer")
    p_name = pa_["p_name"][:SF1_PARTS]
    sess.create_dataframe({"p_name": p_name}, num_partitions=4
                          ).createOrReplaceTempView("part")
    v = np.ma.getdata(fact["v"])[:FLOAT_SLICE_ROWS]
    sess.create_dataframe({"u": np.arange(v.size), "v": v,
                           "f": v.astype(np.float32)},
                          num_partitions=4).createOrReplaceTempView("fact_f")
    log(f"  views made in {time.perf_counter() - t0:.2f} s (l_comment from "
        f"{len(comments)} comments of TPC-H words)")
    book: dict = {}
    runs: dict = {}
    calls = {k: [] for k in STRING_TAIL_KERNELS}
    on_card = {"md5": lambda a: a[0].is_cuda,
               "dtoa_shortest": lambda a: a[0].is_cuda,
               "dfa_search": lambda a: a[1].is_cuda,
               "dfa_match_spans": lambda a: a[1].is_cuda}

    def run(label, sql, must):
        mine = {k: [] for k in STRING_TAIL_KERNELS}
        with recording(K, "md5", mine["md5"], on_card["md5"]), \
                recording(K, "dtoa_shortest", mine["dtoa_shortest"],
                          on_card["dtoa_shortest"]), \
                recording(K, "dfa_search", mine["dfa_search"],
                          on_card["dfa_search"]), \
                recording(K, "dfa_match_spans", mine["dfa_match_spans"],
                          on_card["dfa_match_spans"]):
            out, launches, secs = drive(
                f"3p {label}", lambda: sess.sql(sql).collect(), K, torch,
                must, book)
        for k in STRING_TAIL_KERNELS:
            calls[k] += [(label, c) for c in mine[k]]
        for k, e in check_string_tail_calls(
                K, torch, label, {k: c for k, c in mine.items() if c}
        ).items():
            err[k] = max(err[k], e)
        runs[label] = dict(sql=sql, cold_s=secs, launches=launches,
                           calls=mine)
        return out

    def work(label, name, **live):
        runs[label].setdefault("work", {})[name] = string_tail_work(
            name, runs[label]["calls"][name], **live)

    # the live rows' byte lengths of the items' string inputs
    oc_lens = np.array([len(c.encode()) for c in TPCH_ORDER_COMMENTS]
                       )[_comment_index(od["o_comment"])]

    # RLIKE: q13's words, a count of 1.5M comments
    t = run("rlike", "SELECT count(*) n FROM orders WHERE o_comment RLIKE "
            "'special.*requests'", ("dfa_search",))
    hits = [c for c in TPCH_ORDER_COMMENTS
            if re.search("special.*requests", c)]
    want = int(np.isin(od["o_comment"], hits).sum())
    if t.to_pylist() != [{"n": want}]:
        raise AssertionError(f"rlike: {t.to_pylist()} vs {want}")
    work("rlike", "dfa_search", lens=oc_lens)
    log(f"  o_comment RLIKE 'special.*requests': {want} rows, exact")

    # regexp_replace over l_comment, aggregated by l_returnflag
    t = run("regexp_replace", "SELECT l_returnflag f, sum(length("
            "regexp_replace(l_comment, '[aeiou]+', '#'))) n, max("
            "regexp_replace(l_comment, '[aeiou]+', '#')) m FROM lineitem "
            "GROUP BY l_returnflag ORDER BY f", ("dfa_match_spans",))
    rep = [re.sub("[aeiou]+", "#", c) for c in comments]
    rep_len = np.array([len(r.encode()) for r in rep])
    want = []
    for f in np.unique(li["l_returnflag"]).tolist():
        sel = li["l_returnflag"] == f
        used = np.unique(cidx[sel])
        want.append({"f": f, "n": int(rep_len[cidx[sel]].sum()),
                     "m": max(rep[i] for i in used)})
    if t.to_pylist() != want:
        raise AssertionError(f"regexp_replace: {t.to_pylist()} vs {want}")
    work("regexp_replace", "dfa_match_spans",
         lens=np.array([len(c.encode()) for c in comments])[cidx])
    log(f"  regexp_replace over {n} l_comment rows by l_returnflag: exact")

    # regexp_extract of the country code
    t = run("regexp_extract", "SELECT regexp_extract(c_phone, '^[0-9]+', 0) "
            "cc, count(*) n FROM customer GROUP BY cc ORDER BY cc",
            ("dfa_match_spans",))
    cc = np.array([re.match("^[0-9]+", p).group(0) for p in cu["c_phone"]])
    want = [{"cc": k, "n": c} for k, c in sorted(_group_of(cc).items())]
    if t.to_pylist() != want:
        raise AssertionError("regexp_extract: country codes differ")
    work("regexp_extract", "dfa_match_spans",
         lens=np.array([len(p.encode()) for p in cu["c_phone"]]))
    log(f"  regexp_extract(c_phone, '^[0-9]+', 0): {len(want)} codes over "
        f"{cc.size} rows, exact")

    # split(p_name, ' ')
    t = run("split", "SELECT split(p_name, ' ') parts FROM part",
            ("dfa_match_spans",))
    got = t.to_pydict()["parts"]
    if [list(p) for p in got] != [s.split(" ") for s in p_name]:
        raise AssertionError("split(p_name, ' ') differs from str.split")
    log(f"  split(p_name, ' '): {len(got)} rows, exact")

    # md5(o_comment), grouped by the digest
    t = run("md5", "SELECT md5(o_comment) h, count(*) n FROM orders GROUP "
            "BY h ORDER BY h", ("md5",))
    digests = np.array([hashlib.md5(c.encode()).hexdigest()
                        for c in TPCH_ORDER_COMMENTS])
    counts = _group_of(digests[_comment_index(od["o_comment"])])
    want = [{"h": h, "n": counts[h]} for h in sorted(counts)]
    if t.to_pylist() != want:
        raise AssertionError(f"md5: {t.to_pylist()} vs {want}")
    work("md5", "md5", lens=oc_lens)
    log(f"  md5(o_comment): {len(want)} digests over {od['o_comment'].size}"
        " rows, hashlib's")

    # doubles as text: l_extendedprice (6M) by l_returnflag; the texts of
    # money in [901, 105850] are repr's, written from the cents: each
    # row's length, its '.5' ending, and its digits without the '.' read
    # as a long (1234.5 -> 12345, 1234.56 -> 123456), summed
    t = run("cast_double", "SELECT l_returnflag f, sum(length(CAST("
            "l_extendedprice AS STRING))) n, sum(CASE WHEN CAST("
            "l_extendedprice AS STRING) LIKE '%.5' THEN 1 ELSE 0 END) h, "
            "sum(CAST(replace(CAST(l_extendedprice AS STRING), '.', '') AS "
            "BIGINT)) d FROM lineitem GROUP BY l_returnflag ORDER BY f",
            ("dtoa_shortest",))
    cents = np.round(li["l_extendedprice"] * 100).astype(np.int64)
    whole, frac = np.divmod(cents, 100)
    tenths = frac % 10 == 0
    text_len = (np.floor(np.log10(whole)).astype(np.int64) + 2
                + np.where(tenths, 1, 2))
    text_digits = np.where(tenths, whole * 10 + frac // 10, cents)
    want = [{"f": f, "n": int(text_len[li["l_returnflag"] == f].sum()),
             "h": int(((frac == 50) & (li["l_returnflag"] == f)).sum()),
             "d": int(text_digits[li["l_returnflag"] == f].sum())}
            for f in np.unique(li["l_returnflag"]).tolist()]
    if t.to_pylist() != want:
        raise AssertionError(f"cast l_extendedprice: {t.to_pylist()} vs "
                             f"{want}")
    work("cast_double", "dtoa_shortest", values=n)
    log("  CAST(l_extendedprice AS STRING) by l_returnflag: lengths, '.5' "
        "endings and digit sums exact")

    # FLOAT_SLICE_ROWS rows of the fact table as text, row by row: its
    # doubles (Double.toString) and the same values as floats
    # (Float.toString)
    t = run("cast_float", "SELECT u, CAST(f AS STRING) s, CAST(v AS STRING)"
            " d FROM fact_f", ("dtoa_shortest",))

    def check_texts(got, v):
        d = got.to_pydict()
        for u, s, x in zip(d["u"], d["s"], d["d"]):
            if s != java_float(np.float32(v[u])) or x != java_double(v[u]):
                raise AssertionError(f"cast {v[u]!r}: {s}, {x}")
    check_later("3p cast_float", check_texts, t, v)

    # q1's sums through format_number
    t = run("format_number", "SELECT l_returnflag, l_linestatus, "
            "sum(l_extendedprice) s, format_number(sum(l_extendedprice), 2) "
            "p, format_number(sum(l_quantity), 0) q, format_number(avg("
            "l_extendedprice), 4) a FROM lineitem WHERE l_shipdate <= DATE "
            "'1998-09-02' GROUP BY l_returnflag, l_linestatus ORDER BY "
            "l_returnflag, l_linestatus", ("dtoa_shortest",))
    keep = li["l_shipdate"] <= np.datetime64("1998-09-02")
    for row in t.to_pylist():
        sel = keep & (li["l_returnflag"] == row["l_returnflag"]) & \
            (li["l_linestatus"] == row["l_linestatus"])
        _close(row["s"], li["l_extendedprice"][sel].sum(),
               "format_number's sum")
        if row["p"] != java_format_number(row["s"], 2) or \
                row["q"] != f"{int(li['l_quantity'][sel].sum()):,}":
            raise AssertionError(f"format_number: {row}")
    log(f"  q1's sums through format_number: {t.num_rows} groups, "
        "DecimalFormat's text of the sums")

    # conv to hex
    t = run("conv", "SELECT max(conv(CAST(o_orderkey AS STRING), 10, 16)) m,"
            " sum(length(conv(CAST(o_orderkey AS STRING), 10, 16))) n FROM "
            "orders", ())
    keys = od["o_orderkey"]
    hexes = [format(int(k), "X") for k in keys]
    want = [{"m": max(hexes), "n": sum(len(h) for h in hexes)}]
    if t.to_pylist() != want:
        raise AssertionError(f"conv: {t.to_pylist()} vs {want}")
    log(f"  conv(o_orderkey, 10, 16) over {keys.size} rows: exact")

    # translate with a non-ASCII set
    t = run("translate", "SELECT translate(p_name, 'ae', 'äé') t, count(*) n"
            " FROM part GROUP BY t ORDER BY t", ())
    names, counts = np.unique(p_name, return_counts=True)
    table = str.maketrans({"a": "ä", "e": "é"})
    want = sorted(({"t": s.translate(table), "n": int(c)}
                   for s, c in zip(names.tolist(), counts.tolist())),
                  key=lambda r: r["t"].encode())
    if t.to_pylist() != want:
        raise AssertionError("translate(p_name, 'ae', 'äé') differs")
    log(f"  translate(p_name, 'ae', 'äé'): {len(want)} names, exact")

    total = {k: sum(b[k] for b in book.values()) for k in K.LAUNCHES}
    by_path.update(book)
    log(f"  phase 3p's launches of the hand kernels: {total}")
    for k in STRING_TAIL_KERNELS:
        if total[k] < 1:
            raise AssertionError(f"phase 3p launched no {k}")
    string_tail_matrix(srt, started)
    return {"runs": runs, "calls": calls, "launches": total, "sess": sess}


def _comment_index(values):
    """Each o_comment's index in TPCH_ORDER_COMMENTS."""
    order = np.argsort(TPCH_ORDER_COMMENTS)
    return order[np.searchsorted(np.array(TPCH_ORDER_COMMENTS)[order],
                                 values)]


def make_string_tail_matrix(rows: int, seed: int = STRING_MATRIX_SEED):
    """Strings of 0 to 10 characters over digits, letters, ',', '-', ' ',
    'é', 'ä' and '中' (nulls among them; at most 30 bytes, so the plain
    span walk, quadratic in the width, stays cheap on the cpu), doubles of
    every magnitude with NaN, +-inf and -0.0, floats, and longs."""
    rng = np.random.default_rng(seed)
    alphabet = np.array(list("0123456789abcfxz,- é中ä"))
    lens = rng.integers(0, 11, rows)
    flat = rng.choice(alphabet, int(lens.sum()))
    bounds = np.concatenate([[0], np.cumsum(lens)])
    s = np.array(["".join(flat[a:b]) for a, b in zip(bounds[:-1],
                                                     bounds[1:])],
                 dtype=object)
    s[rng.random(rows) < 0.02] = None
    d = rng.standard_normal(rows) * 10.0 ** rng.integers(-8, 25, rows)
    d[:6] = [np.nan, np.inf, -np.inf, -0.0, 5e-324, 1e23]
    return {"u": np.arange(rows), "s": s, "d": d,
            "f": np.float32(rng.standard_normal(rows) * 1e3),
            "i": rng.integers(-(1 << 62), 1 << 62, rows)}


STRING_TAIL_MATRIX = """SELECT u, md5(s) a, conv(s, 16, 10) b,
    conv(s, 10, -36) c, format_number(d, 3) e, format_number(i, 1) g,
    CAST(d AS STRING) h, CAST(f AS STRING) k, translate(s, 'aé', 'ä中') l,
    trim(s, 'é ') m, s RLIKE '[0-9]+x' n, regexp_replace(s, '[0-9]+', '#')
    o, regexp_extract(s, '[a-z]+', 0) p, split(s, ',') q,
    regexp_extract_all(s, '[0-9]', 0) r FROM m16 ORDER BY u"""


def string_tail_matrix_side(srt, device: str, data) -> dict:
    """STRING_TAIL_MATRIX on ``device``: each column as a list."""
    s = srt.session(device=device)
    s.create_dataframe(data, num_partitions=4).createOrReplaceTempView("m16")
    return s.sql(STRING_TAIL_MATRIX).collect().to_pydict()


def start_string_tail_matrix_cpu(srt):
    """Phase 3p's matrix inputs and its CPU side, started in a thread that
    runs beside the card's phases.  Returns (pool, future, data)."""
    data = make_string_tail_matrix(MATRIX_ROWS)
    pool = ThreadPoolExecutor(1)
    return pool, pool.submit(string_tail_matrix_side, srt, "cpu", data), data


def string_tail_matrix(srt, started) -> None:
    """Phase 3p's matrix: every function of the slice over 262,144 rows on
    cuda, held against the CPU side ``started`` began: every column
    equal."""
    pool, future, data = started
    t0 = time.perf_counter()
    cuda = string_tail_matrix_side(srt, "cuda", data)
    log(f"  the slice's matrix on cuda: {len(cuda['u'])} rows x "
        f"{len(cuda)} columns in {time.perf_counter() - t0:.2f} s")

    def check(cpu):
        pool.shutdown()
        for name in cuda:
            if cuda[name] != cpu[name]:
                raise AssertionError(f"slice matrix: {name} differs between "
                                     "cuda and the cpu")
        log("  the slice's matrix agrees on cuda and the cpu: every column "
            "equal")
    cpu_side("slice matrix", future, check)


def strings_times(strings: dict, K, torch) -> dict:
    """Phase 4's part for phase 3p: each item warm (one run after the cold
    one), and each kernel on the calls of one item (each launch after an L2
    flush that reads) against its plain version and its bound: md5 on
    md5(o_comment)'s, dtoa_shortest on CAST(l_extendedprice AS STRING)'s,
    dfa_search on the RLIKE count's, dfa_match_spans on regexp_extract's
    (c_phone; the plain version's lanes are [rows, width + 1]) and, kernel
    only, on regexp_replace's over l_comment."""
    report = []
    sess = strings["sess"]
    for label, rr in strings["runs"].items():
        t0 = time.perf_counter()
        sess.sql(rr["sql"]).collect()
        torch.cuda.synchronize()
        report.append({"item": label, "cold_ms": rr["cold_s"] * 1e3,
                       "warm_ms": (time.perf_counter() - t0) * 1e3,
                       "launches": {k: rr["launches"][k]
                                    for k in STRING_TAIL_KERNELS}})
    log(json.dumps({"strings": report}))
    runs = strings["runs"]
    out = {}

    def timed(label, name, kernel, plain, plain_too=True):
        """Kernel and plain ms summed over item ``label``'s calls of
        ``name``; the bound from the item's live rows
        (:func:`string_tail_work`): its bytes' or its operations' time,
        the larger."""
        calls = runs[label]["calls"][name]
        ms = plain_ms = 0.0
        for args in calls:
            ms += cuda_ms(lambda: kernel(*args), flush_l2=True)
            if plain_too:
                plain_ms += cuda_ms(lambda: plain(*args), iters=3, warmup=1,
                                    flush_l2=True)
        nbytes, ops = runs[label]["work"][name]
        b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
        return dict(ms=ms, plain_ms=plain_ms if plain_too else None,
                    bound_ms=max(b, o), launches=len(calls),
                    bound_by="operations" if o > b else "bytes")

    out["md5"] = timed("md5", "md5", K.md5, K.md5_plain)
    out["dtoa_shortest"] = timed("cast_double", "dtoa_shortest",
                                 K.dtoa_shortest, K.dtoa_plain)
    out["dfa_search"] = timed("rlike", "dfa_search", K.dfa_search,
                              K.dfa_search_plain)
    out["dfa_match_spans"] = timed("regexp_extract", "dfa_match_spans",
                                   K.dfa_match_spans,
                                   K.dfa_match_spans_plain)
    big = timed("regexp_replace", "dfa_match_spans", K.dfa_match_spans,
                None, plain_too=False)
    card = nvidia_smi_card()
    for name, t in out.items():
        log(f"  {name} per phase 3p item ({t['launches']} launches, each "
            f"after the flush): kernel {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms, "
            f"{t['bound_ms'] / max(t['ms'], 1e-12):.1%} of it; library_ms "
            f"null: no torch call computes it [{card}]")
    share = big["bound_ms"] / max(big["ms"], 1e-12)
    log(f"  dfa_match_spans over l_comment ({big['launches']} launches, "
        f"{SF1_LINEITEM} rows): kernel {big['ms']:.5f} ms, bound "
        f"{big['bound_ms']:.5f} ms, {share:.1%} of it [{card}]")
    out["dfa_match_spans"]["l_comment_ms"] = big["ms"]
    out["dfa_match_spans"]["l_comment_bound_ms"] = big["bound_ms"]
    return out


# --------------------------------------------------------------------------
# phase 3j: the scale rig's 44 TPC-DS SQL queries and five DataFrame shapes
# --------------------------------------------------------------------------

#: store_sales rows: TPC-DS SF1 has 2,880,404
TPCDS_ROWS = 2_880_000
TPCDS_SEED = 31

TPCDS_BUY_POTENTIAL = ["0-500", "501-1000", "1001-5000", "5001-10000",
                       ">10000"]
TPCDS_CITIES = ["Fairview", "Midway", "Oakdale", "Springdale", "Riverside",
                "Centerville", "Glendale", "Marion"]
TPCDS_COUNTIES = ["C1", "C2", "C3", "C4"]
TPCDS_STORE_NAMES = ["ese", "ought", "able", "pri", "bar"]
TPCDS_FIRST = ["Ann", "Bob", "Cara", "Dev", "Eli", "Fay", "Gus", "Hana"]
TPCDS_LAST = ["Ames", "Brown", "Cole", "Diaz", "Egan", "Ford", "Gray",
              "Hale"]
TPCDS_STATES = ["CA", "WA", "GA", "TX", "NY", "OH", "FL", "MI"]
TPCDS_ZIPS = [f"{z:05d}" for z in
              (85669, 86197, 88274, 83405, 80348, 81891, 60099, 90831,
               73065, 24128, 41904, 12477, 31678, 56557, 62544, 29741,
               48933, 74330, 95315, 67853)]
TPCDS_SM_TYPES = ["EXPRESS", "OVERNIGHT", "REGULAR", "TWO DAY", "LIBRARY"]
TPCDS_WH_NAMES = ["Conventional childr", "Important issues liv",
                  "Doors canno", "Bad cards must make", "Rooms cook"]
TPCDS_EDUCATION = ["College", "Primary", "Secondary", "Advanced Degree"]


def _pick(rng, values, n: int):
    """``rng.choice(values, n)`` of a list, as a numpy array (the same
    draws: an index per row)."""
    return np.array(values)[rng.choice(len(values), n)]


def make_tpcds_tables(rows: int, seed: int = TPCDS_SEED):
    """The JAX package's TPC-DS star (``testing/tpcds_queries.py``
    ``build_tables``, seed 31): the same draws from the same two streams,
    in its order, every table and column, with ``rows`` store_sales rows,
    rows // 2 catalog_sales and inventory rows, rows // 3 web_sales rows,
    rows // 5 store_returns rows, rows // 50 items, rows // 20 customers
    and half as many addresses, and the dimensions at the generator's
    fixed sizes.  Every surrogate key is its row (0..n-1).  Strings are
    numpy str arrays."""
    rng = np.random.default_rng(seed)
    n_items = max(rows // 50, 20)
    n_dates = 365 * 5
    n_cd, n_promo, n_stores, n_hd = 200, 50, 12, 144
    n_times = 24 * 12
    n_cust = max(rows // 20, 50)
    n_addr = max(n_cust // 2, 25)
    i32 = np.int32

    day = np.arange(n_dates)
    date_dim = {
        "d_date_sk": day,
        "d_year": (1998 + day // 365).astype(i32),
        "d_moy": (1 + (day % 365) // 31 % 12).astype(i32),
        "d_dom": (1 + day % 28).astype(i32),
        "d_dow": (day % 7).astype(i32),
        "d_qoy": (1 + ((day % 365) // 92) % 4).astype(i32),
    }
    item = {
        "i_item_sk": np.arange(n_items),
        "i_manufact_id": rng.integers(0, 100, n_items).astype(i32),
        "i_brand_id": rng.integers(0, 40, n_items).astype(i32),
        "i_category_id": rng.integers(0, 10, n_items).astype(i32),
        "i_manager_id": rng.integers(0, 100, n_items).astype(i32),
        "i_brand": _numbered("brand#", rng.integers(0, 40, n_items)),
        "i_item_id": _numbered("ITEM", np.arange(n_items), 8),
        "i_class_id": rng.integers(0, 16, n_items).astype(i32),
        "i_current_price": np.round(rng.random(n_items) * 99, 2),
    }
    customer_demographics = {
        "cd_demo_sk": np.arange(n_cd),
        "cd_gender": _pick(rng, ["M", "F"], n_cd),
        "cd_marital_status": _pick(rng, ["S", "M", "D", "W"], n_cd),
        "cd_education_status": _pick(rng, TPCDS_EDUCATION, n_cd),
    }
    promotion = {
        "p_promo_sk": np.arange(n_promo),
        "p_channel_email": _pick(rng, ["Y", "N"], n_promo),
        "p_channel_event": _pick(rng, ["Y", "N"], n_promo),
    }
    store = {
        "s_store_sk": np.arange(n_stores),
        "s_store_name": _pick(rng, TPCDS_STORE_NAMES, n_stores),
        "s_city": _pick(rng, TPCDS_CITIES, n_stores),
        "s_county": _pick(rng, TPCDS_COUNTIES, n_stores),
        "s_number_employees": rng.integers(150, 350, n_stores).astype(i32),
    }
    household_demographics = {
        "hd_demo_sk": np.arange(n_hd),
        "hd_dep_count": rng.integers(0, 10, n_hd).astype(i32),
        "hd_vehicle_count": rng.integers(0, 5, n_hd).astype(i32),
        "hd_buy_potential": _pick(rng, TPCDS_BUY_POTENTIAL, n_hd),
    }
    tmark = np.arange(n_times)
    time_dim = {"t_time_sk": tmark, "t_hour": (tmark // 12).astype(i32),
                "t_minute": ((tmark % 12) * 5).astype(i32)}
    customer = {
        "c_customer_sk": np.arange(n_cust),
        "c_first_name": _pick(rng, TPCDS_FIRST, n_cust),
        "c_last_name": _pick(rng, TPCDS_LAST, n_cust),
        "c_current_addr_sk": rng.integers(0, n_addr, n_cust),
        "c_current_cdemo_sk": rng.integers(0, n_cd, n_cust),
    }
    customer_address = {
        "ca_address_sk": np.arange(n_addr),
        "ca_city": _pick(rng, TPCDS_CITIES, n_addr),
        "ca_county": _pick(rng, TPCDS_COUNTIES, n_addr),
        "ca_state": _pick(rng, TPCDS_STATES, n_addr),
        "ca_zip": _pick(rng, TPCDS_ZIPS, n_addr),
    }
    n_wh = 5
    warehouse = {
        "w_warehouse_sk": np.arange(n_wh),
        "w_warehouse_name": np.array(TPCDS_WH_NAMES[:n_wh]),
        "w_state": np.array([TPCDS_STATES[i % len(TPCDS_STATES)]
                             for i in range(n_wh)]),
    }
    n_sm = len(TPCDS_SM_TYPES)
    ship_mode = {"sm_ship_mode_sk": np.arange(n_sm),
                 "sm_type": np.array(TPCDS_SM_TYPES)}

    # tickets share one date, time, store, household, customer and address
    n_tickets = max(rows // 8, 10)
    tk_date = rng.integers(0, n_dates, n_tickets)
    tk_time = rng.integers(0, n_times, n_tickets)
    tk_store = rng.integers(0, n_stores, n_tickets)
    tk_hd = rng.integers(0, n_hd, n_tickets)
    tk_cust = rng.integers(0, n_cust, n_tickets)
    tk_addr = rng.integers(0, n_addr, n_tickets)
    ticket = rng.integers(0, n_tickets, rows)
    store_sales = {"ss_sold_date_sk": tk_date[ticket]}
    store_sales["ss_item_sk"] = rng.integers(0, n_items, rows)
    store_sales["ss_ext_sales_price"] = np.round(rng.random(rows) * 1000, 2)
    store_sales["ss_cdemo_sk"] = rng.integers(0, n_cd, rows)
    store_sales["ss_promo_sk"] = rng.integers(0, n_promo, rows)
    store_sales["ss_quantity"] = rng.integers(1, 100, rows).astype(i32)
    store_sales["ss_list_price"] = np.round(rng.random(rows) * 200, 2)
    store_sales["ss_coupon_amt"] = np.round(rng.random(rows) * 50, 2)
    store_sales["ss_store_sk"] = tk_store[ticket]
    store_sales["ss_hdemo_sk"] = tk_hd[ticket]
    store_sales["ss_sold_time_sk"] = tk_time[ticket]
    store_sales["ss_ticket_number"] = ticket
    store_sales["ss_customer_sk"] = tk_cust[ticket]
    store_sales["ss_addr_sk"] = tk_addr[ticket]
    store_sales["ss_net_profit"] = np.round(rng.random(rows) * 100 - 20, 2)
    store_sales["ss_sales_price"] = np.round(rng.random(rows) * 150, 2)
    store_sales["ss_ext_list_price"] = np.round(rng.random(rows) * 250, 2)
    store_sales["ss_ext_tax"] = np.round(rng.random(rows) * 30, 2)

    n_cs = max(rows // 2, 20)
    catalog_sales = {"cs_sold_date_sk": rng.integers(0, n_dates, n_cs)}
    catalog_sales["cs_bill_customer_sk"] = rng.integers(0, n_cust, n_cs)
    catalog_sales["cs_item_sk"] = rng.integers(0, n_items, n_cs)
    catalog_sales["cs_quantity"] = rng.integers(1, 100, n_cs).astype(i32)
    catalog_sales["cs_list_price"] = np.round(rng.random(n_cs) * 200, 2)
    catalog_sales["cs_ext_sales_price"] = np.round(rng.random(n_cs) * 1000,
                                                   2)
    catalog_sales["cs_sales_price"] = np.round(rng.random(n_cs) * 600, 2)
    catalog_sales["cs_net_profit"] = np.round(rng.random(n_cs) * 120 - 25, 2)
    catalog_sales["cs_sold_time_sk"] = rng.integers(0, n_times, n_cs)
    catalog_sales["cs_order_number"] = rng.integers(0, max(n_cs // 3, 8),
                                                    n_cs)
    catalog_sales["cs_warehouse_sk"] = rng.integers(0, n_wh, n_cs)
    catalog_sales["cs_cdemo_sk"] = rng.integers(0, n_cd, n_cs)
    catalog_sales["cs_promo_sk"] = rng.integers(0, n_promo, n_cs)
    n_cr = max(n_cs // 5, 8)
    cr_idx = rng.choice(n_cs, size=n_cr, replace=False)
    catalog_returns = {
        "cr_order_number": catalog_sales["cs_order_number"][cr_idx],
        "cr_item_sk": catalog_sales["cs_item_sk"][cr_idx],
        "cr_refunded_cash": np.round(rng.random(n_cr) * 80, 2),
    }
    n_inv = max(rows // 2, 40)
    inv_items = min(n_items, 50)
    inventory = {"inv_date_sk": rng.integers(800, 1100, n_inv)}
    inventory["inv_item_sk"] = rng.integers(0, inv_items, n_inv)
    inventory["inv_warehouse_sk"] = rng.integers(0, n_wh, n_inv)
    inventory["inv_quantity_on_hand"] = rng.integers(0, 1000, n_inv).astype(
        i32)
    n_ws = max(rows // 3, 20)
    ws_sold = rng.integers(0, n_dates, n_ws)
    n_orders = max(n_ws // 3, 8)
    web_sales = {"ws_sold_date_sk": ws_sold}
    web_sales["ws_bill_customer_sk"] = rng.integers(0, n_cust, n_ws)
    web_sales["ws_item_sk"] = rng.integers(0, n_items, n_ws)
    web_sales["ws_quantity"] = rng.integers(1, 100, n_ws).astype(i32)
    web_sales["ws_list_price"] = np.round(rng.random(n_ws) * 200, 2)
    web_sales["ws_ext_sales_price"] = np.round(rng.random(n_ws) * 1000, 2)
    web_sales["ws_ship_date_sk"] = np.minimum(
        ws_sold + rng.integers(1, 140, n_ws), n_dates - 1)
    web_sales["ws_sold_time_sk"] = rng.integers(0, n_times, n_ws)
    web_sales["ws_order_number"] = rng.integers(0, n_orders, n_ws)
    web_sales["ws_warehouse_sk"] = rng.integers(0, n_wh, n_ws)
    web_sales["ws_ship_mode_sk"] = rng.integers(0, n_sm, n_ws)
    web_sales["ws_ship_hdemo_sk"] = rng.integers(0, n_hd, n_ws)
    web_sales["ws_ext_discount_amt"] = np.round(rng.random(n_ws) * 80, 2)
    web_sales["ws_ext_ship_cost"] = np.round(rng.random(n_ws) * 40, 2)
    web_sales["ws_net_profit"] = np.round(rng.random(n_ws) * 110 - 20, 2)
    n_wr = max(n_orders // 4, 4)
    web_returns = {
        "wr_order_number": rng.choice(n_orders, size=n_wr, replace=False),
        "wr_return_amt": np.round(rng.random(n_wr) * 200, 2),
    }
    n_sr = max(rows // 5, 10)
    ret_idx = rng.choice(rows, size=n_sr, replace=False)
    store_returns = {
        "sr_returned_date_sk": rng.integers(0, n_dates, n_sr),
        "sr_customer_sk": store_sales["ss_customer_sk"][ret_idx],
        "sr_store_sk": store_sales["ss_store_sk"][ret_idx],
        "sr_item_sk": store_sales["ss_item_sk"][ret_idx],
        "sr_ticket_number": store_sales["ss_ticket_number"][ret_idx],
    }
    store_returns["sr_return_amt"] = np.round(rng.random(n_sr) * 300, 2)
    store_returns["sr_net_loss"] = np.round(rng.random(n_sr) * 90, 2)
    # the generator's second stream, appended columns
    rng2 = np.random.default_rng(seed + 101)
    store["s_state"] = np.array([TPCDS_STATES[i % len(TPCDS_STATES)]
                                 for i in range(n_stores)])
    n_cc = 6
    call_center = {"cc_call_center_sk": np.arange(n_cc),
                   "cc_name": _numbered("call center ", np.arange(n_cc))}
    catalog_sales["cs_ship_date_sk"] = np.minimum(
        catalog_sales["cs_sold_date_sk"] + rng2.integers(1, 140, n_cs),
        n_dates - 1)
    catalog_sales["cs_ship_mode_sk"] = rng2.integers(0, n_sm, n_cs)
    catalog_sales["cs_call_center_sk"] = rng2.integers(0, n_cc, n_cs)
    return {
        "store_sales": store_sales, "date_dim": date_dim, "item": item,
        "customer_demographics": customer_demographics,
        "promotion": promotion, "store": store,
        "household_demographics": household_demographics,
        "time_dim": time_dim, "customer": customer,
        "customer_address": customer_address,
        "catalog_sales": catalog_sales, "web_sales": web_sales,
        "store_returns": store_returns, "warehouse": warehouse,
        "ship_mode": ship_mode, "web_returns": web_returns,
        "catalog_returns": catalog_returns, "inventory": inventory,
        "call_center": call_center,
    }


#: testing/tpcds_queries.py's 44 QUERY_SET texts, as it writes them
TPCDS_Q34 = """
SELECT c_last_name, c_first_name, ss_ticket_number, cnt
FROM (SELECT ss_ticket_number, ss_customer_sk, count(*) AS cnt
      FROM store_sales, date_dim, store, household_demographics
      WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk
        AND (d_dom BETWEEN 1 AND 3 OR d_dom BETWEEN 25 AND 28)
        AND hd_buy_potential = '1001-5000' AND hd_vehicle_count > 0
        AND d_year IN (1998, 1999, 2000) AND s_county = 'C1'
      GROUP BY ss_ticket_number, ss_customer_sk) dn, customer
WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN 2 AND 20
ORDER BY c_last_name, c_first_name, ss_ticket_number DESC
"""

TPCDS_Q42 = """
SELECT d_year, i_category_id, sum(ss_ext_sales_price) AS s
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id <= 15 AND d_moy = 12 AND d_year = 2000
GROUP BY d_year, i_category_id
ORDER BY s DESC, d_year, i_category_id
"""

TPCDS_Q52 = """
SELECT d_year, i_brand_id, sum(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id <= 10 AND d_moy = 11 AND d_year = 2000
GROUP BY d_year, i_brand_id
ORDER BY d_year, ext_price DESC
"""

TPCDS_Q53 = """
SELECT i_manufact_id, d_qoy, sum_sales,
       avg(sum_sales) OVER (PARTITION BY i_manufact_id)
         AS avg_quarterly_sales
FROM (SELECT i_manufact_id, d_qoy, sum(ss_sales_price) AS sum_sales
      FROM item, store_sales, date_dim, store
      WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
        AND ss_store_sk = s_store_sk AND d_qoy IN (1, 2)
        AND i_class_id < 8
      GROUP BY i_manufact_id, d_qoy) tmp1
ORDER BY avg_quarterly_sales, sum_sales, i_manufact_id
"""

TPCDS_Q55 = """
SELECT i_brand_id, i_brand, sum(ss_ext_sales_price) AS ext_price
FROM date_dim, store_sales, item
WHERE d_date_sk = ss_sold_date_sk AND ss_item_sk = i_item_sk
  AND i_manager_id BETWEEN 20 AND 40 AND d_moy = 11 AND d_year = 1999
GROUP BY i_brand, i_brand_id
ORDER BY ext_price DESC, i_brand_id
"""

TPCDS_Q59 = """
SELECT y1.s_store_name, y1.d_dow, y1.rev1, y2.rev2,
       y2.rev2 / y1.rev1 AS ratio
FROM (SELECT s_store_name, d_dow, sum(ss_ext_sales_price) AS rev1
      FROM store_sales, date_dim, store
      WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
        AND d_year = 1998
      GROUP BY s_store_name, d_dow) y1,
     (SELECT s_store_name, d_dow, sum(ss_ext_sales_price) AS rev2
      FROM store_sales, date_dim, store
      WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
        AND d_year = 1999
      GROUP BY s_store_name, d_dow) y2
WHERE y1.s_store_name = y2.s_store_name AND y1.d_dow = y2.d_dow
ORDER BY y1.s_store_name, y1.d_dow
"""

TPCDS_Q68 = """
SELECT c_last_name, c_first_name, current_addr.ca_city, bought_city,
       ss_ticket_number, ss_addr_sk, extended_price, extended_tax,
       list_price
FROM (SELECT ss_ticket_number, ss_customer_sk, ss_addr_sk,
             ca_city AS bought_city,
             sum(ss_ext_sales_price) AS extended_price,
             sum(ss_ext_list_price) AS list_price,
             sum(ss_ext_tax) AS extended_tax
      FROM store_sales, date_dim, store, household_demographics,
           customer_address
      WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk AND ss_addr_sk = ca_address_sk
        AND d_dom BETWEEN 1 AND 2
        AND (hd_dep_count = 4 OR hd_vehicle_count = 3)
        AND d_year IN (1998, 1999, 2000)
        AND s_city IN ('Fairview', 'Midway')
      GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, ca_city) dn,
     customer, customer_address current_addr
WHERE ss_customer_sk = c_customer_sk
  AND customer.c_current_addr_sk = current_addr.ca_address_sk
  AND current_addr.ca_city <> bought_city
ORDER BY c_last_name, ss_ticket_number
"""

TPCDS_Q73 = """
SELECT c_last_name, c_first_name, ss_ticket_number, cnt
FROM (SELECT ss_ticket_number, ss_customer_sk, count(*) AS cnt
      FROM store_sales, date_dim, store, household_demographics
      WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk AND d_dom BETWEEN 1 AND 2
        AND hd_buy_potential IN ('501-1000', '>10000')
        AND hd_vehicle_count > 0 AND d_year IN (1998, 1999, 2000)
        AND s_county IN ('C1', 'C2')
      GROUP BY ss_ticket_number, ss_customer_sk) dj, customer
WHERE ss_customer_sk = c_customer_sk AND cnt BETWEEN 1 AND 5
ORDER BY cnt DESC, c_last_name
"""

TPCDS_Q79 = """
SELECT c_last_name, c_first_name, substr(s_city, 1, 30) AS city30,
       ss_ticket_number, ss_addr_sk, amt, profit
FROM (SELECT ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city,
             sum(ss_coupon_amt) AS amt, sum(ss_net_profit) AS profit
      FROM store_sales, date_dim, store, household_demographics
      WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
        AND ss_hdemo_sk = hd_demo_sk
        AND (hd_dep_count = 6 OR hd_vehicle_count > 2)
        AND d_dow = 1 AND d_year IN (1998, 1999, 2000)
        AND s_number_employees BETWEEN 200 AND 295
      GROUP BY ss_ticket_number, ss_customer_sk, ss_addr_sk, s_city) ms,
     customer
WHERE ss_customer_sk = c_customer_sk
ORDER BY c_last_name, c_first_name, city30, profit
"""

TPCDS_Q88 = (
    '\n'
    'SELECT * FROM\n'
    ' (SELECT count(*) AS h8_30_to_9 FROM store_sales, '
    'household_demographics, time_dim, store WHERE ss_sold_time_sk = '
    't_time_sk AND ss_hdemo_sk = hd_demo_sk AND ss_store_sk = '
    's_store_sk AND t_hour = 8 AND t_minute >= 30 AND t_minute < 60 '
    "AND hd_dep_count = 3 AND s_store_name = 'ese') s1,\n"
    ' (SELECT count(*) AS h9_to_9_30 FROM store_sales, '
    'household_demographics, time_dim, store WHERE ss_sold_time_sk = '
    't_time_sk AND ss_hdemo_sk = hd_demo_sk AND ss_store_sk = '
    's_store_sk AND t_hour = 9 AND t_minute >= 0 AND t_minute < 30 AND '
    "hd_dep_count = 3 AND s_store_name = 'ese') s2,\n"
    ' (SELECT count(*) AS h9_30_to_10 FROM store_sales, '
    'household_demographics, time_dim, store WHERE ss_sold_time_sk = '
    't_time_sk AND ss_hdemo_sk = hd_demo_sk AND ss_store_sk = '
    's_store_sk AND t_hour = 9 AND t_minute >= 30 AND t_minute < 60 '
    "AND hd_dep_count = 3 AND s_store_name = 'ese') s3,\n"
    ' (SELECT count(*) AS h10_to_10_30 FROM store_sales, '
    'household_demographics, time_dim, store WHERE ss_sold_time_sk = '
    't_time_sk AND ss_hdemo_sk = hd_demo_sk AND ss_store_sk = '
    's_store_sk AND t_hour = 10 AND t_minute >= 0 AND t_minute < 30 '
    "AND hd_dep_count = 3 AND s_store_name = 'ese') s4\n")

TPCDS_Q96 = """
SELECT count(*) AS cnt
FROM store_sales, household_demographics, time_dim, store
WHERE ss_sold_time_sk = t_time_sk AND ss_hdemo_sk = hd_demo_sk
  AND ss_store_sk = s_store_sk AND t_hour = 20 AND t_minute >= 30
  AND hd_dep_count = 7 AND s_store_name = 'ese'
"""

TPCDS_Q98 = """
SELECT i_item_id, i_category_id, i_class_id, i_current_price,
       itemrevenue,
       itemrevenue * 100 / sum(itemrevenue)
         OVER (PARTITION BY i_class_id) AS revenueratio
FROM (SELECT i_item_id, i_category_id, i_class_id, i_current_price,
             sum(ss_ext_sales_price) AS itemrevenue
      FROM store_sales, item, date_dim
      WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk
        AND i_category_id IN (1, 2, 3) AND d_year = 1999
      GROUP BY i_item_id, i_category_id, i_class_id,
               i_current_price) grouped
ORDER BY i_category_id, i_class_id, i_item_id, revenueratio
"""

TPCDS_Q1 = """
WITH customer_total_return AS (
  SELECT sr_customer_sk AS ctr_customer_sk, sr_store_sk AS ctr_store_sk,
         sum(sr_return_amt) AS ctr_total_return
  FROM store_returns, date_dim
  WHERE sr_returned_date_sk = d_date_sk AND d_year = 2000
  GROUP BY sr_customer_sk, sr_store_sk)
SELECT c_customer_sk, c_first_name, c_last_name
FROM customer_total_return ctr1, store, customer
WHERE ctr1.ctr_total_return >
      (SELECT avg(ctr_total_return) * 1.2
       FROM customer_total_return ctr2
       WHERE ctr1.ctr_store_sk = ctr2.ctr_store_sk)
  AND s_store_sk = ctr1.ctr_store_sk AND s_county = 'C1'
  AND ctr1.ctr_customer_sk = c_customer_sk
ORDER BY c_customer_sk
"""

TPCDS_Q2 = """
WITH wscs AS (
  SELECT d_year, d_dow, ws_ext_sales_price AS sales_price
  FROM web_sales, date_dim WHERE ws_sold_date_sk = d_date_sk
  UNION ALL
  SELECT d_year, d_dow, cs_ext_sales_price
  FROM catalog_sales, date_dim WHERE cs_sold_date_sk = d_date_sk)
SELECT d_year, d_dow, sum(sales_price) AS total
FROM wscs GROUP BY d_year, d_dow ORDER BY d_year, d_dow
"""

TPCDS_Q11 = """
WITH year_total AS (
  SELECT ss_customer_sk AS customer_sk, d_year AS dyear,
         sum(ss_ext_sales_price) AS year_total, 's' AS sale_type
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk
  GROUP BY ss_customer_sk, d_year
  UNION ALL
  SELECT ws_bill_customer_sk, d_year, sum(ws_ext_sales_price), 'w'
  FROM web_sales, date_dim
  WHERE ws_sold_date_sk = d_date_sk
  GROUP BY ws_bill_customer_sk, d_year)
SELECT t_s_secyear.customer_sk
FROM year_total t_s_firstyear, year_total t_s_secyear,
     year_total t_w_firstyear, year_total t_w_secyear
WHERE t_s_secyear.customer_sk = t_s_firstyear.customer_sk
  AND t_s_firstyear.customer_sk = t_w_secyear.customer_sk
  AND t_s_firstyear.customer_sk = t_w_firstyear.customer_sk
  AND t_s_firstyear.sale_type = 's' AND t_w_firstyear.sale_type = 'w'
  AND t_s_secyear.sale_type = 's' AND t_w_secyear.sale_type = 'w'
  AND t_s_firstyear.dyear = 1999 AND t_s_secyear.dyear = 2000
  AND t_w_firstyear.dyear = 1999 AND t_w_secyear.dyear = 2000
  AND t_s_firstyear.year_total > 0 AND t_w_firstyear.year_total > 0
  AND t_w_secyear.year_total / t_w_firstyear.year_total
      > t_s_secyear.year_total / t_s_firstyear.year_total
ORDER BY t_s_secyear.customer_sk
"""

TPCDS_Q27 = """
SELECT i_item_id, s_county, avg(ss_quantity) AS agg1,
       avg(ss_list_price) AS agg2, avg(ss_coupon_amt) AS agg3,
       avg(ss_sales_price) AS agg4
FROM store_sales, customer_demographics, date_dim, store, item
WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk
  AND ss_cdemo_sk = cd_demo_sk AND ss_item_sk = i_item_sk
  AND cd_gender = 'M' AND cd_marital_status = 'S'
  AND cd_education_status = 'College' AND d_year = 2000
GROUP BY ROLLUP(i_item_id, s_county)
ORDER BY i_item_id, s_county
"""

TPCDS_Q31 = """
WITH ss AS (
  SELECT ca_county, d_qoy, d_year,
         sum(ss_ext_sales_price) AS store_sales_total
  FROM store_sales, date_dim, customer_address
  WHERE ss_sold_date_sk = d_date_sk AND ss_addr_sk = ca_address_sk
  GROUP BY ca_county, d_qoy, d_year),
ws AS (
  SELECT ca_county, d_qoy, d_year,
         sum(ws_ext_sales_price) AS web_sales_total
  FROM web_sales, date_dim, customer, customer_address
  WHERE ws_sold_date_sk = d_date_sk
    AND ws_bill_customer_sk = c_customer_sk
    AND c_current_addr_sk = ca_address_sk
  GROUP BY ca_county, d_qoy, d_year)
SELECT ss1.ca_county,
       ss2.store_sales_total / ss1.store_sales_total AS store_growth,
       ws2.web_sales_total / ws1.web_sales_total AS web_growth,
       CASE WHEN ws2.web_sales_total / ws1.web_sales_total
                 > ss2.store_sales_total / ss1.store_sales_total
            THEN 1 ELSE 0 END AS web_faster
FROM ss ss1, ss ss2, ws ws1, ws ws2
WHERE ss1.ca_county = ss2.ca_county AND ss1.ca_county = ws1.ca_county
  AND ss1.ca_county = ws2.ca_county
  AND ss1.d_qoy = 1 AND ss2.d_qoy = 2 AND ws1.d_qoy = 1 AND ws2.d_qoy = 2
  AND ss1.d_year = 2000 AND ss2.d_year = 2000
  AND ws1.d_year = 2000 AND ws2.d_year = 2000
ORDER BY ss1.ca_county
"""

TPCDS_Q38 = """
SELECT count(*) AS num FROM (
  SELECT DISTINCT c_last_name, c_first_name, c_customer_sk
  FROM store_sales, date_dim, customer
  WHERE ss_sold_date_sk = d_date_sk AND ss_customer_sk = c_customer_sk
    AND d_year = 1999
  INTERSECT
  SELECT DISTINCT c_last_name, c_first_name, c_customer_sk
  FROM catalog_sales, date_dim, customer
  WHERE cs_sold_date_sk = d_date_sk AND cs_bill_customer_sk = c_customer_sk
    AND d_year = 1999
  INTERSECT
  SELECT DISTINCT c_last_name, c_first_name, c_customer_sk
  FROM web_sales, date_dim, customer
  WHERE ws_sold_date_sk = d_date_sk AND ws_bill_customer_sk = c_customer_sk
    AND d_year = 1999
) hot_cust
"""

TPCDS_Q60 = """
WITH ss AS (
  SELECT i_item_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, item
  WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
    AND i_category_id = 3 AND d_year = 1999
  GROUP BY i_item_id),
cs AS (
  SELECT i_item_id, sum(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, item
  WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
    AND i_category_id = 3 AND d_year = 1999
  GROUP BY i_item_id),
ws AS (
  SELECT i_item_id, sum(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, item
  WHERE ws_sold_date_sk = d_date_sk AND ws_item_sk = i_item_sk
    AND i_category_id = 3 AND d_year = 1999
  GROUP BY i_item_id)
SELECT i_item_id, sum(total_sales) AS total_sales
FROM (SELECT * FROM ss UNION ALL SELECT * FROM cs
      UNION ALL SELECT * FROM ws) tmp1
GROUP BY i_item_id
ORDER BY i_item_id, total_sales
"""

TPCDS_Q65 = """
WITH sa AS (
  SELECT ss_store_sk, ss_item_sk, sum(ss_sales_price) AS revenue
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_year = 1999
  GROUP BY ss_store_sk, ss_item_sk),
sc AS (
  SELECT ss_store_sk, avg(revenue) AS ave FROM sa GROUP BY ss_store_sk)
SELECT s_store_name, i_item_id, sa.revenue
FROM store, item, sa, sc
WHERE sa.ss_store_sk = sc.ss_store_sk AND sa.revenue <= 0.5 * sc.ave
  AND s_store_sk = sa.ss_store_sk AND i_item_sk = sa.ss_item_sk
ORDER BY s_store_name, i_item_id
"""

TPCDS_Q69 = """
SELECT cd_gender, cd_marital_status, cd_education_status,
       count(*) AS cnt
FROM customer c, customer_address ca, customer_demographics
WHERE c.c_current_addr_sk = ca.ca_address_sk
  AND ca_county IN ('C1', 'C2')
  AND cd_demo_sk = c.c_current_cdemo_sk
  AND EXISTS (SELECT * FROM store_sales, date_dim
              WHERE c.c_customer_sk = ss_customer_sk
                AND ss_sold_date_sk = d_date_sk AND d_year = 2000)
  AND NOT EXISTS (SELECT * FROM web_sales, date_dim
                  WHERE c.c_customer_sk = ws_bill_customer_sk
                    AND ws_sold_date_sk = d_date_sk AND d_year = 2000)
  AND NOT EXISTS (SELECT * FROM catalog_sales, date_dim
                  WHERE c.c_customer_sk = cs_bill_customer_sk
                    AND cs_sold_date_sk = d_date_sk AND d_year = 2000)
GROUP BY cd_gender, cd_marital_status, cd_education_status
ORDER BY cd_gender, cd_marital_status, cd_education_status
"""

TPCDS_Q87 = """
SELECT count(*) AS num FROM (
  SELECT DISTINCT c_last_name, c_first_name, c_customer_sk
  FROM store_sales, date_dim, customer
  WHERE ss_sold_date_sk = d_date_sk AND ss_customer_sk = c_customer_sk
    AND d_year = 1999
  EXCEPT
  SELECT DISTINCT c_last_name, c_first_name, c_customer_sk
  FROM catalog_sales, date_dim, customer
  WHERE cs_sold_date_sk = d_date_sk AND cs_bill_customer_sk = c_customer_sk
    AND d_year = 1999
  EXCEPT
  SELECT DISTINCT c_last_name, c_first_name, c_customer_sk
  FROM web_sales, date_dim, customer
  WHERE ws_sold_date_sk = d_date_sk AND ws_bill_customer_sk = c_customer_sk
    AND d_year = 1999
) cool_cust
"""

TPCDS_Q93 = """
SELECT ss_customer_sk, sum(act_sales) AS sumsales
FROM (SELECT ss_customer_sk,
             CASE WHEN sr_ticket_number IS NOT NULL
                  THEN ss_sales_price * (ss_quantity - 1)
                  ELSE ss_sales_price * ss_quantity END AS act_sales
      FROM store_sales LEFT JOIN store_returns
        ON sr_ticket_number = ss_ticket_number
       AND sr_item_sk = ss_item_sk) t
GROUP BY ss_customer_sk
ORDER BY sumsales, ss_customer_sk
"""

TPCDS_Q97 = """
WITH ssci AS (
  SELECT ss_customer_sk AS customer_sk, ss_item_sk AS item_sk
  FROM store_sales, date_dim
  WHERE ss_sold_date_sk = d_date_sk AND d_year = 1999
  GROUP BY ss_customer_sk, ss_item_sk),
csci AS (
  SELECT cs_bill_customer_sk AS customer_sk, cs_item_sk AS item_sk
  FROM catalog_sales, date_dim
  WHERE cs_sold_date_sk = d_date_sk AND d_year = 1999
  GROUP BY cs_bill_customer_sk, cs_item_sk)
SELECT sum(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NULL THEN 1 ELSE 0 END)
         AS store_only,
       sum(CASE WHEN ssci.customer_sk IS NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
         AS catalog_only,
       sum(CASE WHEN ssci.customer_sk IS NOT NULL
                 AND csci.customer_sk IS NOT NULL THEN 1 ELSE 0 END)
         AS store_and_catalog
FROM ssci FULL OUTER JOIN csci
  ON (ssci.customer_sk = csci.customer_sk
      AND ssci.item_sk = csci.item_sk)
"""

TPCDS_Q15 = """
SELECT ca_zip, sum(cs_sales_price) AS total
FROM catalog_sales, customer, customer_address, date_dim
WHERE cs_bill_customer_sk = c_customer_sk
  AND c_current_addr_sk = ca_address_sk
  AND (substr(ca_zip, 1, 5) IN ('85669', '86197', '88274', '83405', '80348')
       OR ca_state IN ('CA', 'WA', 'GA') OR cs_sales_price > 500)
  AND cs_sold_date_sk = d_date_sk AND d_qoy = 1 AND d_year = 2000
GROUP BY ca_zip
ORDER BY ca_zip
"""

TPCDS_Q25 = """
SELECT i_item_id, s_store_name,
       sum(ss_net_profit) AS store_profit,
       sum(sr_net_loss) AS return_loss,
       sum(cs_net_profit) AS catalog_profit
FROM store_sales, store_returns, catalog_sales, date_dim d1, date_dim d2,
     date_dim d3, item, store
WHERE d1.d_year = 2000 AND d1.d_date_sk = ss_sold_date_sk
  AND i_item_sk = ss_item_sk AND s_store_sk = ss_store_sk
  AND ss_customer_sk = sr_customer_sk AND ss_item_sk = sr_item_sk
  AND ss_ticket_number = sr_ticket_number
  AND sr_returned_date_sk = d2.d_date_sk AND d2.d_year IN (2000, 2001)
  AND sr_customer_sk = cs_bill_customer_sk AND sr_item_sk = cs_item_sk
  AND cs_sold_date_sk = d3.d_date_sk AND d3.d_year IN (2000, 2001)
GROUP BY i_item_id, s_store_name
ORDER BY i_item_id, s_store_name
"""

TPCDS_Q33 = """
WITH ss AS (
  SELECT i_manufact_id, sum(ss_ext_sales_price) AS total_sales
  FROM store_sales, date_dim, item
  WHERE ss_sold_date_sk = d_date_sk AND ss_item_sk = i_item_sk
    AND i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category_id = 3)
    AND d_year = 1999
  GROUP BY i_manufact_id),
cs AS (
  SELECT i_manufact_id, sum(cs_ext_sales_price) AS total_sales
  FROM catalog_sales, date_dim, item
  WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
    AND i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category_id = 3)
    AND d_year = 1999
  GROUP BY i_manufact_id),
ws AS (
  SELECT i_manufact_id, sum(ws_ext_sales_price) AS total_sales
  FROM web_sales, date_dim, item
  WHERE ws_sold_date_sk = d_date_sk AND ws_item_sk = i_item_sk
    AND i_manufact_id IN (SELECT i_manufact_id FROM item
                          WHERE i_category_id = 3)
    AND d_year = 1999
  GROUP BY i_manufact_id)
SELECT i_manufact_id, sum(total_sales) AS total_sales
FROM (SELECT * FROM ss UNION ALL SELECT * FROM cs
      UNION ALL SELECT * FROM ws) tmp1
GROUP BY i_manufact_id
ORDER BY i_manufact_id
"""

TPCDS_Q50 = (
    '\n'
    'SELECT s_store_name,\n'
    '  sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk <= 30\n'
    '           THEN 1 ELSE 0 END) AS d30,\n'
    '  sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 30 AND '
    'sr_returned_date_sk - ss_sold_date_sk <= 60\n'
    '           THEN 1 ELSE 0 END) AS d60,\n'
    '  sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 60 AND '
    'sr_returned_date_sk - ss_sold_date_sk <= 90\n'
    '           THEN 1 ELSE 0 END) AS d90,\n'
    '  sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 90 AND '
    'sr_returned_date_sk - ss_sold_date_sk <= 120\n'
    '           THEN 1 ELSE 0 END) AS d120,\n'
    '  sum(CASE WHEN sr_returned_date_sk - ss_sold_date_sk > 120\n'
    '           THEN 1 ELSE 0 END) AS dmore\n'
    'FROM store_sales, store_returns, store, date_dim d2\n'
    'WHERE ss_ticket_number = sr_ticket_number AND ss_item_sk = '
    'sr_item_sk\n'
    '  AND ss_customer_sk = sr_customer_sk\n'
    '  AND sr_returned_date_sk = d2.d_date_sk AND d2.d_year = 2000\n'
    '  AND ss_store_sk = s_store_sk\n'
    'GROUP BY s_store_name\n'
    'ORDER BY s_store_name\n')

TPCDS_Q61 = (
    '\n'
    'SELECT promotions, total, promotions / total * 100 AS ratio\n'
    'FROM (SELECT sum(ss_ext_sales_price) AS promotions\n'
    '  \n'
    '  FROM store_sales, promotion, store, date_dim, customer,\n'
    '       customer_address, item\n'
    '  WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk\n'
    '    AND ss_customer_sk = c_customer_sk\n'
    '    AND ca_address_sk = c_current_addr_sk AND ss_item_sk = '
    'i_item_sk\n'
    "    AND s_county = 'C1' AND ca_county IN ('C1', 'C2')\n"
    '    AND i_category_id = 3 AND d_year = 2000\n'
    '    AND ss_promo_sk = p_promo_sk\n'
    "    AND (p_channel_email = 'Y' OR p_channel_event = 'Y')) "
    'promotional,\n'
    ' (SELECT sum(ss_ext_sales_price) AS total\n'
    '  \n'
    '  FROM store_sales, store, date_dim, customer,\n'
    '       customer_address, item\n'
    '  WHERE ss_sold_date_sk = d_date_sk AND ss_store_sk = s_store_sk\n'
    '    AND ss_customer_sk = c_customer_sk\n'
    '    AND ca_address_sk = c_current_addr_sk AND ss_item_sk = '
    'i_item_sk\n'
    "    AND s_county = 'C1' AND ca_county IN ('C1', 'C2')\n"
    '    AND i_category_id = 3 AND d_year = 2000) all_sales\n')

TPCDS_Q62 = (
    '\n'
    'SELECT substr(w_warehouse_name, 1, 20) AS wname, sm_type,\n'
    '  sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk <= 30\n'
    '           THEN 1 ELSE 0 END) AS d30,\n'
    '  sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 30 AND '
    'ws_ship_date_sk - ws_sold_date_sk <= 60\n'
    '           THEN 1 ELSE 0 END) AS d60,\n'
    '  sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 60 AND '
    'ws_ship_date_sk - ws_sold_date_sk <= 90\n'
    '           THEN 1 ELSE 0 END) AS d90,\n'
    '  sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 90 AND '
    'ws_ship_date_sk - ws_sold_date_sk <= 120\n'
    '           THEN 1 ELSE 0 END) AS d120,\n'
    '  sum(CASE WHEN ws_ship_date_sk - ws_sold_date_sk > 120\n'
    '           THEN 1 ELSE 0 END) AS dmore\n'
    'FROM web_sales, warehouse, ship_mode, date_dim\n'
    'WHERE ws_ship_date_sk = d_date_sk AND d_year = 2000\n'
    '  AND ws_warehouse_sk = w_warehouse_sk\n'
    '  AND ws_ship_mode_sk = sm_ship_mode_sk\n'
    'GROUP BY substr(w_warehouse_name, 1, 20), sm_type\n'
    'ORDER BY wname, sm_type\n')

TPCDS_Q71 = """
SELECT i_brand_id, i_brand, t_hour, t_minute,
       sum(ext_price) AS ext_price
FROM item,
 (SELECT ws_ext_sales_price AS ext_price, ws_item_sk AS sold_item_sk,
         ws_sold_time_sk AS time_sk
  FROM web_sales, date_dim
  WHERE d_date_sk = ws_sold_date_sk AND d_moy = 11 AND d_year = 1999
  UNION ALL
  SELECT cs_ext_sales_price, cs_item_sk, cs_sold_time_sk
  FROM catalog_sales, date_dim
  WHERE d_date_sk = cs_sold_date_sk AND d_moy = 11 AND d_year = 1999
  UNION ALL
  SELECT ss_ext_sales_price, ss_item_sk, ss_sold_time_sk
  FROM store_sales, date_dim
  WHERE d_date_sk = ss_sold_date_sk AND d_moy = 11
    AND d_year = 1999) tmp,
 time_dim
WHERE sold_item_sk = i_item_sk AND i_manager_id <= 20
  AND time_sk = t_time_sk AND t_hour BETWEEN 8 AND 10
GROUP BY i_brand_id, i_brand, t_hour, t_minute
ORDER BY ext_price DESC, i_brand_id, t_hour, t_minute
"""

TPCDS_Q90 = (
    '\n'
    'SELECT amc * 1.0 / pmc AS am_pm_ratio\n'
    'FROM (SELECT count(*) AS amc FROM web_sales, '
    'household_demographics, time_dim WHERE ws_ship_hdemo_sk = '
    'hd_demo_sk AND ws_sold_time_sk = t_time_sk AND t_hour BETWEEN 7 '
    'AND 9 AND hd_dep_count = 3) at, (SELECT count(*) AS pmc FROM '
    'web_sales, household_demographics, time_dim WHERE '
    'ws_ship_hdemo_sk = hd_demo_sk AND ws_sold_time_sk = t_time_sk AND '
    't_hour BETWEEN 17 AND 19 AND hd_dep_count = 3) pt\n')

TPCDS_Q92 = """
SELECT sum(ws_ext_discount_amt) AS excess
FROM web_sales ws1, item, date_dim
WHERE i_item_sk = ws1.ws_item_sk AND i_manufact_id <= 30
  AND ws1.ws_sold_date_sk = d_date_sk AND d_year = 2000
  AND ws1.ws_ext_discount_amt >
      (SELECT 1.3 * avg(ws_ext_discount_amt)
       FROM web_sales ws2, date_dim d2
       WHERE ws2.ws_item_sk = ws1.ws_item_sk
         AND ws2.ws_sold_date_sk = d2.d_date_sk AND d2.d_year = 2000)
"""

TPCDS_Q94 = """
SELECT count(DISTINCT ws_order_number) AS order_count,
       sum(ws_ext_ship_cost) AS total_shipping_cost,
       sum(ws_net_profit) AS total_net_profit
FROM web_sales ws1, date_dim, warehouse
WHERE ws1.ws_ship_date_sk = d_date_sk AND d_year = 2000
  AND ws1.ws_warehouse_sk = w_warehouse_sk AND w_state = 'CA'
  AND EXISTS (SELECT * FROM web_sales ws2
              WHERE ws1.ws_order_number = ws2.ws_order_number
                AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
  AND NOT EXISTS (SELECT * FROM web_returns wr1
                  WHERE ws1.ws_order_number = wr1.wr_order_number)
"""

TPCDS_Q21 = """
SELECT w_warehouse_name, i_item_id,
       sum(CASE WHEN inv_date_sk < 900
                THEN inv_quantity_on_hand ELSE 0 END) AS inv_before,
       sum(CASE WHEN inv_date_sk >= 900
                THEN inv_quantity_on_hand ELSE 0 END) AS inv_after
FROM inventory, warehouse, item, date_dim
WHERE inv_item_sk = i_item_sk AND inv_warehouse_sk = w_warehouse_sk
  AND inv_date_sk = d_date_sk AND d_date_sk BETWEEN 840 AND 960
GROUP BY w_warehouse_name, i_item_id
HAVING sum(CASE WHEN inv_date_sk < 900
                THEN inv_quantity_on_hand ELSE 0 END) > 0
   AND sum(CASE WHEN inv_date_sk >= 900
                THEN inv_quantity_on_hand ELSE 0 END) * 3
       >= sum(CASE WHEN inv_date_sk < 900
                   THEN inv_quantity_on_hand ELSE 0 END) * 2
   AND sum(CASE WHEN inv_date_sk >= 900
                THEN inv_quantity_on_hand ELSE 0 END) * 2
       <= sum(CASE WHEN inv_date_sk < 900
                   THEN inv_quantity_on_hand ELSE 0 END) * 3
ORDER BY w_warehouse_name, i_item_id
"""

TPCDS_Q37 = """
SELECT i_item_id, i_current_price
FROM item, inventory, date_dim, catalog_sales
WHERE i_current_price BETWEEN 20 AND 50 AND i_manufact_id <= 40
  AND inv_item_sk = i_item_sk AND d_date_sk = inv_date_sk
  AND d_date_sk BETWEEN 900 AND 960
  AND inv_quantity_on_hand BETWEEN 100 AND 500
  AND cs_item_sk = i_item_sk
GROUP BY i_item_id, i_current_price
ORDER BY i_item_id
"""

TPCDS_Q40 = """
SELECT w_state, i_item_id,
  sum(CASE WHEN cs_sold_date_sk < 900
           THEN cs_sales_price - coalesce(cr_refunded_cash, 0)
           ELSE 0 END) AS sales_before,
  sum(CASE WHEN cs_sold_date_sk >= 900
           THEN cs_sales_price - coalesce(cr_refunded_cash, 0)
           ELSE 0 END) AS sales_after
FROM catalog_sales LEFT JOIN catalog_returns
  ON (cs_order_number = cr_order_number AND cs_item_sk = cr_item_sk),
  warehouse, item, date_dim
WHERE i_current_price BETWEEN 20 AND 70 AND i_item_sk = cs_item_sk
  AND cs_warehouse_sk = w_warehouse_sk AND cs_sold_date_sk = d_date_sk
  AND d_date_sk BETWEEN 840 AND 960
GROUP BY w_state, i_item_id
ORDER BY w_state, i_item_id
"""

TPCDS_Q43 = """
SELECT s_store_name,
  sum(CASE WHEN d_dow = 0 THEN ss_sales_price ELSE 0 END) AS sun_sales,
  sum(CASE WHEN d_dow = 1 THEN ss_sales_price ELSE 0 END) AS mon_sales,
  sum(CASE WHEN d_dow = 2 THEN ss_sales_price ELSE 0 END) AS tue_sales,
  sum(CASE WHEN d_dow = 3 THEN ss_sales_price ELSE 0 END) AS wed_sales,
  sum(CASE WHEN d_dow = 4 THEN ss_sales_price ELSE 0 END) AS thu_sales,
  sum(CASE WHEN d_dow = 5 THEN ss_sales_price ELSE 0 END) AS fri_sales,
  sum(CASE WHEN d_dow = 6 THEN ss_sales_price ELSE 0 END) AS sat_sales
FROM date_dim, store_sales, store
WHERE d_date_sk = ss_sold_date_sk AND s_store_sk = ss_store_sk
  AND d_year = 2000
GROUP BY s_store_name
ORDER BY s_store_name
"""

TPCDS_Q48 = """
SELECT sum(ss_quantity) AS total_quantity
FROM store_sales, store, customer_demographics, customer_address,
     date_dim
WHERE s_store_sk = ss_store_sk AND ss_sold_date_sk = d_date_sk
  AND d_year = 2000
  AND ((cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'M'
        AND cd_education_status = 'Advanced Degree'
        AND ss_sales_price BETWEEN 100.00 AND 150.00)
    OR (cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'S'
        AND cd_education_status = 'College'
        AND ss_sales_price BETWEEN 50.00 AND 100.00)
    OR (cd_demo_sk = ss_cdemo_sk AND cd_marital_status = 'W'
        AND cd_education_status = 'Secondary'
        AND ss_sales_price BETWEEN 0.00 AND 50.00))
  AND ((ss_addr_sk = ca_address_sk AND ca_state IN ('CA', 'WA')
        AND ss_net_profit BETWEEN 0 AND 50)
    OR (ss_addr_sk = ca_address_sk AND ca_state IN ('GA', 'TX')
        AND ss_net_profit BETWEEN 50 AND 80)
    OR (ss_addr_sk = ca_address_sk AND ca_state IN ('NY', 'OH')
        AND ss_net_profit BETWEEN -20 AND 20))
"""

TPCDS_Q95 = """
WITH ws_wh AS (
  SELECT ws1.ws_order_number
  FROM web_sales ws1, web_sales ws2
  WHERE ws1.ws_order_number = ws2.ws_order_number
    AND ws1.ws_warehouse_sk <> ws2.ws_warehouse_sk)
SELECT count(DISTINCT ws_order_number) AS order_count,
       sum(ws_ext_ship_cost) AS total_shipping_cost,
       sum(ws_net_profit) AS total_net_profit
FROM web_sales ws1, date_dim, warehouse
WHERE ws1.ws_ship_date_sk = d_date_sk AND d_year = 2000
  AND ws1.ws_warehouse_sk = w_warehouse_sk AND w_state = 'CA'
  AND ws1.ws_order_number IN (SELECT ws_order_number FROM ws_wh)
  AND ws1.ws_order_number IN (SELECT wr_order_number
                              FROM web_returns, ws_wh
                              WHERE wr_order_number = ws_wh.ws_order_number)
"""

TPCDS_Q18 = """
SELECT i_item_id, ca_state, ca_county,
       avg(cs_quantity) AS agg1, avg(cs_list_price) AS agg2
FROM catalog_sales, customer_demographics, customer, customer_address,
     date_dim, item
WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
  AND cs_bill_customer_sk = c_customer_sk
  AND cs_cdemo_sk = cd_demo_sk
  AND c_current_addr_sk = ca_address_sk
  AND cd_gender = 'F' AND cd_education_status = 'College'
  AND d_year = 2000
GROUP BY ROLLUP(i_item_id, ca_state, ca_county)
ORDER BY i_item_id, ca_state, ca_county
"""

TPCDS_Q26 = """
SELECT i_item_id, avg(cs_quantity) AS agg1,
       avg(cs_list_price) AS agg2, avg(cs_sales_price) AS agg3
FROM catalog_sales, customer_demographics, date_dim, item, promotion
WHERE cs_sold_date_sk = d_date_sk AND cs_item_sk = i_item_sk
  AND cs_cdemo_sk = cd_demo_sk AND cs_promo_sk = p_promo_sk
  AND cd_gender = 'F' AND cd_marital_status = 'S'
  AND cd_education_status = 'College'
  AND (p_channel_email = 'N' OR p_channel_event = 'N')
  AND d_year = 2000
GROUP BY i_item_id
ORDER BY i_item_id
"""

TPCDS_Q39 = """
WITH inv1 AS (
  SELECT inv_warehouse_sk AS w, inv_item_sk AS i,
         avg(inv_quantity_on_hand) AS qty_mean,
         stddev_samp(inv_quantity_on_hand)
           / avg(inv_quantity_on_hand) AS qty_cov
  FROM inventory, date_dim
  WHERE inv_date_sk = d_date_sk AND d_year = 2000 AND d_moy = 4
  GROUP BY inv_warehouse_sk, inv_item_sk
  HAVING stddev_samp(inv_quantity_on_hand)
           / avg(inv_quantity_on_hand) > 0.5), inv2 AS (
  SELECT inv_warehouse_sk AS w, inv_item_sk AS i,
         avg(inv_quantity_on_hand) AS qty_mean,
         stddev_samp(inv_quantity_on_hand)
           / avg(inv_quantity_on_hand) AS qty_cov
  FROM inventory, date_dim
  WHERE inv_date_sk = d_date_sk AND d_year = 2000 AND d_moy = 5
  GROUP BY inv_warehouse_sk, inv_item_sk
  HAVING stddev_samp(inv_quantity_on_hand)
           / avg(inv_quantity_on_hand) > 0.5)
SELECT inv1.w, inv1.i, inv1.qty_mean AS mean_1, inv1.qty_cov AS cov_1,
       inv2.qty_mean AS mean_2, inv2.qty_cov AS cov_2
FROM inv1, inv2
WHERE inv1.w = inv2.w AND inv1.i = inv2.i
ORDER BY inv1.w, inv1.i
"""

TPCDS_Q58 = (
    '\n'
    'WITH \n'
    'ss_items AS (\n'
    '  SELECT i_item_id AS item_id, sum(ss_ext_sales_price) AS revenue\n'
    '  FROM store_sales, item, date_dim\n'
    '  WHERE ss_item_sk = i_item_sk AND ss_sold_date_sk = d_date_sk\n'
    '    AND d_year = 1999\n'
    '  GROUP BY i_item_id),\n'
    '\n'
    'cs_items AS (\n'
    '  SELECT i_item_id AS item_id, sum(cs_ext_sales_price) AS revenue\n'
    '  FROM catalog_sales, item, date_dim\n'
    '  WHERE cs_item_sk = i_item_sk AND cs_sold_date_sk = d_date_sk\n'
    '    AND d_year = 1999\n'
    '  GROUP BY i_item_id),\n'
    '\n'
    'ws_items AS (\n'
    '  SELECT i_item_id AS item_id, sum(ws_ext_sales_price) AS revenue\n'
    '  FROM web_sales, item, date_dim\n'
    '  WHERE ws_item_sk = i_item_sk AND ws_sold_date_sk = d_date_sk\n'
    '    AND d_year = 1999\n'
    '  GROUP BY i_item_id)\n'
    'SELECT ss_items.item_id, ss_items.revenue AS ss_rev,\n'
    '       cs_items.revenue AS cs_rev, ws_items.revenue AS ws_rev,\n'
    '       (ss_items.revenue + cs_items.revenue + ws_items.revenue) / '
    '3\n'
    '         AS average\n'
    'FROM ss_items, cs_items, ws_items\n'
    'WHERE ss_items.item_id = cs_items.item_id\n'
    '  AND ss_items.item_id = ws_items.item_id\n'
    '  AND ss_items.revenue BETWEEN\n'
    '      0.5 * (ss_items.revenue + cs_items.revenue + '
    'ws_items.revenue) / 3\n'
    '      AND 2.0 * (ss_items.revenue + cs_items.revenue + '
    'ws_items.revenue) / 3\n'
    '  AND cs_items.revenue BETWEEN\n'
    '      0.5 * (ss_items.revenue + cs_items.revenue + '
    'ws_items.revenue) / 3\n'
    '      AND 2.0 * (ss_items.revenue + cs_items.revenue + '
    'ws_items.revenue) / 3\n'
    '  AND ws_items.revenue BETWEEN\n'
    '      0.5 * (ss_items.revenue + cs_items.revenue + '
    'ws_items.revenue) / 3\n'
    '      AND 2.0 * (ss_items.revenue + cs_items.revenue + '
    'ws_items.revenue) / 3\n'
    'ORDER BY ss_items.item_id\n')


def _codes(*pairs):
    """Int64 codes of composite keys, equal across two sides exactly where
    the key tuples are: ``pairs`` holds (left column, right column) per
    key.  Returns (left codes, right codes)."""
    n = len(pairs[0][0])
    code = np.zeros(n + len(pairs[0][1]), dtype=np.int64)
    for left, right in pairs:
        r = _rank(np.concatenate([np.asarray(left), np.asarray(right)]))
        code = _rank(code * (int(r.max()) + 1 if r.size else 1) + r)
    return code[:n], code[n:]


def _pairs(lc, rc):
    """(left rows, right rows) of every pair with equal codes: an inner
    equi-join's matches, left rows in order."""
    order = np.argsort(rc, kind="stable")
    sr = rc[order]
    lo = np.searchsorted(sr, lc, "left")
    cnt = np.searchsorted(sr, lc, "right") - lo
    li = np.repeat(np.arange(lc.size), cnt)
    start = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
    return li, order[start + np.arange(li.size)]


def _gby(keys):
    """(each group's key values, each row's group) of aligned key arrays,
    the groups in key order."""
    code = np.zeros(len(keys[0]), dtype=np.int64)
    for k in keys:
        r = _rank(k)
        code = _rank(code * (int(r.max()) + 1 if r.size else 1) + r)
    _, first, inv = np.unique(code, return_index=True, return_inverse=True)
    return [np.asarray(k)[first] for k in keys], inv.ravel()


def _gsum(inv, values, n=None):
    n = int(inv.max()) + 1 if n is None else n
    return np.bincount(inv, weights=np.asarray(values, dtype=np.float64),
                       minlength=n)


def _gcount(inv, n=None):
    return np.bincount(inv, minlength=int(inv.max()) + 1 if n is None else n)


def _gmean(inv, values):
    return _gsum(inv, values) / _gcount(inv)


def _masked(values, valid):
    """A masked array: ``values`` where ``valid``, null elsewhere."""
    return np.ma.MaskedArray(np.asarray(values), mask=~np.asarray(valid))


def _rows_perm(cols):
    """The order ``tpcds_queries._sorted_frames`` puts rows in: by every
    non-float column, then every float column rounded to 3 digits, nulls
    first."""
    keys = []
    for is_float in (False, True):
        for c in cols:
            data = np.ma.getdata(c)
            if (data.dtype.kind == "f") != is_float:
                continue
            mask = np.ma.getmaskarray(c)
            if is_float:
                data = np.round(data.astype(np.float64), 3)
            r = np.zeros(len(data), dtype=np.int64)
            if (~mask).any():
                r[~mask] = _rank(data[~mask]) + 1
            keys.append(r)
    return np.lexsort(keys[::-1])


def check_multiset(got, exp, label: str) -> None:
    """``tpcds_queries._assert_rows`` in numpy: as many rows and columns as
    the oracle's (``exp``: a list of columns, numpy or masked arrays, by
    position), at least one row, and the same rows as a multiset: floats
    within rtol and atol 1e-6 (NaN equal to NaN), everything else exact,
    nulls where the oracle has them."""
    exp = [np.ma.asarray(c) for c in exp]
    n = len(exp[0])
    if got.num_rows != n:
        raise AssertionError(f"{label}: {got.num_rows} rows, want {n}")
    if len(got.names) != len(exp):
        raise AssertionError(f"{label}: {len(got.names)} columns, want "
                             f"{len(exp)}")
    if n == 0:
        raise AssertionError(f"{label}: the oracle gives no row")
    gcols = [got.column(name) for name in got.names]
    gp, ep = _rows_perm(gcols), _rows_perm(exp)
    for i, (g, e) in enumerate(zip(gcols, exp)):
        g, e = g[gp], e[ep]
        gm, em = np.ma.getmaskarray(g), np.ma.getmaskarray(e)
        if not np.array_equal(gm, em):
            raise AssertionError(f"{label}: nulls of column {i} differ")
        gd, ed = np.ma.getdata(g)[~gm], np.ma.getdata(e)[~em]
        if gd.dtype.kind == "f" or ed.dtype.kind == "f":
            same = np.allclose(gd.astype(np.float64),
                               ed.astype(np.float64), rtol=1e-6, atol=1e-6,
                               equal_nan=True)
        else:
            same = bool(np.all(gd == ed))
        if not same:
            raise AssertionError(f"{label}: column {i} differs")


def _one_row(*values):
    return [np.array([v]) for v in values]


def _ss_dims(t, rows=None):
    """Per store_sales row (of ``rows``): its date, store, household,
    time, customer, address and item dimension rows (every key is its
    row)."""
    ss = t["store_sales"]
    rows = np.arange(len(ss["ss_item_sk"])) if rows is None else rows
    return {"d": ss["ss_sold_date_sk"][rows], "s": ss["ss_store_sk"][rows],
            "h": ss["ss_hdemo_sk"][rows], "tm": ss["ss_sold_time_sk"][rows],
            "c": ss["ss_customer_sk"][rows], "a": ss["ss_addr_sk"][rows],
            "i": ss["ss_item_sk"][rows], "cd": ss["ss_cdemo_sk"][rows],
            "p": ss["ss_promo_sk"][rows]}


def _dim(t, table, name, keys):
    return t[table][name][keys]


def tpcds_q34_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    dom = _dim(t, "date_dim", "d_dom", k["d"])
    keep = ((((dom >= 1) & (dom <= 3)) | ((dom >= 25) & (dom <= 28)))
            & (_dim(t, "household_demographics", "hd_buy_potential", k["h"])
               == "1001-5000")
            & (_dim(t, "household_demographics", "hd_vehicle_count",
                    k["h"]) > 0)
            & np.isin(_dim(t, "date_dim", "d_year", k["d"]),
                      [1998, 1999, 2000])
            & (_dim(t, "store", "s_county", k["s"]) == "C1"))
    (tk, cu), inv = _gby([ss["ss_ticket_number"][keep],
                          ss["ss_customer_sk"][keep]])
    cnt = _gcount(inv)
    sel = (cnt >= 2) & (cnt <= 20)
    c = t["customer"]
    check_multiset(got, [c["c_last_name"][cu[sel]],
                         c["c_first_name"][cu[sel]], tk[sel], cnt[sel]],
                   "q34")


def _ss_sum_by(t, keep, key_fns, value):
    """store_sales rows ``keep`` grouped by ``key_fns`` (each an array over
    every row), the sum of column ``value``."""
    keys, inv = _gby([np.asarray(f)[keep] for f in key_fns])
    return keys, _gsum(inv, t["store_sales"][value][keep])


def _brand_rev(t, manager_ok, moy, year, keys):
    k = _ss_dims(t)
    d, i = k["d"], k["i"]
    keep = (manager_ok(_dim(t, "item", "i_manager_id", i))
            & (_dim(t, "date_dim", "d_moy", d) == moy)
            & (_dim(t, "date_dim", "d_year", d) == year))
    key_cols = {"d_year": _dim(t, "date_dim", "d_year", d),
                "i_brand_id": _dim(t, "item", "i_brand_id", i),
                "i_brand": _dim(t, "item", "i_brand", i),
                "i_category_id": _dim(t, "item", "i_category_id", i)}
    return _ss_sum_by(t, keep, [key_cols[n] for n in keys],
                      "ss_ext_sales_price")


def tpcds_q52_check(got, t):
    (y, b), s = _brand_rev(t, lambda m: m <= 10, 11, 2000,
                           ["d_year", "i_brand_id"])
    check_multiset(got, [y, b, s], "q52")


def tpcds_q42_check(got, t):
    (y, c), s = _brand_rev(t, lambda m: m <= 15, 12, 2000,
                           ["d_year", "i_category_id"])
    check_multiset(got, [y, c, s], "q42")


def tpcds_q55_check(got, t):
    (b, bid), s = _brand_rev(t, lambda m: (m >= 20) & (m <= 40), 11, 1999,
                             ["i_brand", "i_brand_id"])
    check_multiset(got, [bid, b, s], "q55")


def tpcds_q53_check(got, t):
    k = _ss_dims(t)
    qoy = _dim(t, "date_dim", "d_qoy", k["d"])
    man = _dim(t, "item", "i_manufact_id", k["i"])
    keep = np.isin(qoy, [1, 2]) & (_dim(t, "item", "i_class_id", k["i"]) < 8)
    (m, q), s = _ss_sum_by(t, keep, [man, qoy], "ss_sales_price")
    (_, ), minv = _gby([m])
    avg = _gmean(minv, s)[minv]
    check_multiset(got, [m, q, s, avg], "q53")


def tpcds_q68_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    dom = _dim(t, "date_dim", "d_dom", k["d"])
    keep = ((dom >= 1) & (dom <= 2)
            & ((_dim(t, "household_demographics", "hd_dep_count", k["h"])
                == 4)
               | (_dim(t, "household_demographics", "hd_vehicle_count",
                       k["h"]) == 3))
            & np.isin(_dim(t, "date_dim", "d_year", k["d"]),
                      [1998, 1999, 2000])
            & np.isin(_dim(t, "store", "s_city", k["s"]),
                      ["Fairview", "Midway"]))
    city = _dim(t, "customer_address", "ca_city", k["a"])
    (tk, cu, ad, bought), inv = _gby([ss["ss_ticket_number"][keep],
                                      k["c"][keep], k["a"][keep],
                                      city[keep]])
    ext, lst, tax = (_gsum(inv, ss[c][keep]) for c in (
        "ss_ext_sales_price", "ss_ext_list_price", "ss_ext_tax"))
    cur = _dim(t, "customer_address", "ca_city",
               _dim(t, "customer", "c_current_addr_sk", cu))
    sel = cur != bought
    c = t["customer"]
    check_multiset(got, [c["c_last_name"][cu[sel]],
                         c["c_first_name"][cu[sel]], cur[sel], bought[sel],
                         tk[sel], ad[sel], ext[sel], tax[sel], lst[sel]],
                   "q68")


def tpcds_q73_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    dom = _dim(t, "date_dim", "d_dom", k["d"])
    keep = ((dom >= 1) & (dom <= 2)
            & np.isin(_dim(t, "household_demographics", "hd_buy_potential",
                           k["h"]), ["501-1000", ">10000"])
            & (_dim(t, "household_demographics", "hd_vehicle_count",
                    k["h"]) > 0)
            & np.isin(_dim(t, "date_dim", "d_year", k["d"]),
                      [1998, 1999, 2000])
            & np.isin(_dim(t, "store", "s_county", k["s"]), ["C1", "C2"]))
    (tk, cu), inv = _gby([ss["ss_ticket_number"][keep], k["c"][keep]])
    cnt = _gcount(inv)
    sel = (cnt >= 1) & (cnt <= 5)
    c = t["customer"]
    check_multiset(got, [c["c_last_name"][cu[sel]],
                         c["c_first_name"][cu[sel]], tk[sel], cnt[sel]],
                   "q73")


def tpcds_q79_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    emp = _dim(t, "store", "s_number_employees", k["s"])
    keep = (((_dim(t, "household_demographics", "hd_dep_count", k["h"])
              == 6)
             | (_dim(t, "household_demographics", "hd_vehicle_count",
                     k["h"]) > 2))
            & (_dim(t, "date_dim", "d_dow", k["d"]) == 1)
            & np.isin(_dim(t, "date_dim", "d_year", k["d"]),
                      [1998, 1999, 2000])
            & (emp >= 200) & (emp <= 295))
    city = _dim(t, "store", "s_city", k["s"])
    (tk, cu, ad, ci), inv = _gby([ss["ss_ticket_number"][keep],
                                  k["c"][keep], k["a"][keep], city[keep]])
    amt = _gsum(inv, ss["ss_coupon_amt"][keep])
    profit = _gsum(inv, ss["ss_net_profit"][keep])
    c = t["customer"]
    city30 = np.array([s[:30] for s in ci])
    check_multiset(got, [c["c_last_name"][cu], c["c_first_name"][cu],
                         city30, tk, ad, amt, profit], "q79")


def _time_bucket_count(t, h0, m0, m1, dep):
    k = _ss_dims(t)
    hour = _dim(t, "time_dim", "t_hour", k["tm"])
    minute = _dim(t, "time_dim", "t_minute", k["tm"])
    return int(((hour == h0) & (minute >= m0) & (minute < m1)
                & (_dim(t, "household_demographics", "hd_dep_count", k["h"])
                   == dep)
                & (_dim(t, "store", "s_store_name", k["s"]) == "ese")).sum())


def tpcds_q88_check(got, t):
    check_multiset(got, _one_row(_time_bucket_count(t, 8, 30, 60, 3),
                                 _time_bucket_count(t, 9, 0, 30, 3),
                                 _time_bucket_count(t, 9, 30, 60, 3),
                                 _time_bucket_count(t, 10, 0, 30, 3)),
                   "q88")


def tpcds_q96_check(got, t):
    check_multiset(got, _one_row(_time_bucket_count(t, 20, 30, 60, 7)),
                   "q96")


def tpcds_q98_check(got, t):
    k = _ss_dims(t)
    cat = _dim(t, "item", "i_category_id", k["i"])
    keep = np.isin(cat, [1, 2, 3]) & (_dim(t, "date_dim", "d_year", k["d"])
                                      == 1999)
    (iid, c, cl, price), s = _ss_sum_by(
        t, keep, [_dim(t, "item", n, k["i"]) for n in (
            "i_item_id", "i_category_id", "i_class_id", "i_current_price")],
        "ss_ext_sales_price")
    (_, ), cinv = _gby([cl])
    ratio = s * 100 / _gsum(cinv, s)[cinv]
    check_multiset(got, [iid, c, cl, price, s, ratio], "q98")


def tpcds_q59_check(got, t):
    k = _ss_dims(t)
    year = _dim(t, "date_dim", "d_year", k["d"])
    name = _dim(t, "store", "s_store_name", k["s"])
    dow = _dim(t, "date_dim", "d_dow", k["d"])
    (n1, d1), r1 = _ss_sum_by(t, year == 1998, [name, dow],
                              "ss_ext_sales_price")
    (n2, d2), r2 = _ss_sum_by(t, year == 1999, [name, dow],
                              "ss_ext_sales_price")
    li, ri = _pairs(*_codes((n1, n2), (d1, d2)))
    check_multiset(got, [n1[li], d1[li], r1[li], r2[ri], r2[ri] / r1[li]],
                   "q59")


def _fact(t, fact):
    """(the fact table, its date, customer and item key column names)."""
    return {"store_sales": ("ss_sold_date_sk", "ss_customer_sk",
                            "ss_item_sk"),
            "catalog_sales": ("cs_sold_date_sk", "cs_bill_customer_sk",
                              "cs_item_sk"),
            "web_sales": ("ws_sold_date_sk", "ws_bill_customer_sk",
                          "ws_item_sk")}[fact]


def _fact_rows(t, fact, years):
    """The rows of a sales fact sold in ``years``."""
    date_col = _fact(t, fact)[0]
    return np.nonzero(np.isin(
        _dim(t, "date_dim", "d_year", t[fact][date_col]), years))[0]


def _channel_customers(t, fact, year):
    rows = _fact_rows(t, fact, [year])
    return np.unique(t[fact][_fact(t, fact)[1]][rows])


def tpcds_q38_check(got, t):
    s, c, w = (_channel_customers(t, f, 1999) for f in (
        "store_sales", "catalog_sales", "web_sales"))
    check_multiset(got, _one_row(np.intersect1d(np.intersect1d(s, c),
                                                w).size), "q38")


def tpcds_q87_check(got, t):
    s, c, w = (_channel_customers(t, f, 1999) for f in (
        "store_sales", "catalog_sales", "web_sales"))
    check_multiset(got, _one_row(np.setdiff1d(np.setdiff1d(s, c),
                                              w).size), "q87")


def tpcds_q97_check(got, t):
    n_items = len(t["item"]["i_item_sk"])

    def pairs(fact):
        rows = _fact_rows(t, fact, [1999])
        _, cust, item = _fact(t, fact)
        return np.unique(t[fact][cust][rows] * n_items
                         + t[fact][item][rows])
    s, c = pairs("store_sales"), pairs("catalog_sales")
    both = np.intersect1d(s, c).size
    check_multiset(got, _one_row(s.size - both, c.size - both, both), "q97")


def _year_totals(t, fact, price, year):
    """(customers with a row in ``year``, the sum of ``price`` over their
    rows)."""
    rows = _fact_rows(t, fact, [year])
    (cust, ), inv = _gby([t[fact][_fact(t, fact)[1]][rows]])
    return cust, _gsum(inv, t[fact][price][rows])


def tpcds_q11_check(got, t):
    n = len(t["customer"]["c_customer_sk"])
    tot = {}
    for key, fact, price in (("s", "store_sales", "ss_ext_sales_price"),
                             ("w", "web_sales", "ws_ext_sales_price")):
        for year in (1999, 2000):
            cust, sums = _year_totals(t, fact, price, year)
            v = np.full(n, np.nan)
            v[cust] = sums
            tot[key, year] = v
    sf, ss2, wf, ws2 = (tot["s", 1999], tot["s", 2000], tot["w", 1999],
                        tot["w", 2000])
    keep = (~np.isnan(sf) & ~np.isnan(ss2) & ~np.isnan(wf) & ~np.isnan(ws2)
            & (sf > 0) & (wf > 0))
    keep[keep] &= (ws2[keep] / wf[keep]) > (ss2[keep] / sf[keep])
    check_multiset(got, [np.nonzero(keep)[0]], "q11")


def tpcds_q31_check(got, t):
    dd, ss, ws = t["date_dim"], t["store_sales"], t["web_sales"]
    county = t["customer_address"]["ca_county"]
    s_d, w_d = ss["ss_sold_date_sk"], ws["ws_sold_date_sk"]
    s_keep = dd["d_year"][s_d] == 2000
    (sc, sq), s_tot = _gby([county[ss["ss_addr_sk"]][s_keep],
                            dd["d_qoy"][s_d][s_keep]])
    s_tot = _gsum(s_tot, ss["ss_ext_sales_price"][s_keep])
    w_addr = t["customer"]["c_current_addr_sk"][ws["ws_bill_customer_sk"]]
    w_keep = dd["d_year"][w_d] == 2000
    (wc, wq), w_tot = _gby([county[w_addr][w_keep],
                            dd["d_qoy"][w_d][w_keep]])
    w_tot = _gsum(w_tot, ws["ws_ext_sales_price"][w_keep])
    s_map = dict(zip(zip(sc.tolist(), sq.tolist()), s_tot))
    w_map = dict(zip(zip(wc.tolist(), wq.tolist()), w_tot))
    rows = []
    for c in np.unique(county).tolist():
        if not all(k in m for m in (s_map, w_map)
                   for k in ((c, 1), (c, 2))):
            continue
        sg = s_map[c, 2] / s_map[c, 1]
        wg = w_map[c, 2] / w_map[c, 1]
        rows.append((c, sg, wg, 1 if wg > sg else 0))
    check_multiset(got, [np.array([r[i] for r in rows]) for i in range(4)],
                   "q31")


_PRICE = {"store_sales": "ss_ext_sales_price",
          "catalog_sales": "cs_ext_sales_price",
          "web_sales": "ws_ext_sales_price"}


def _channel_sums(t, key_of_item, keep_item, year=1999):
    """The three channels' rows sold in ``year`` whose item passes
    ``keep_item``, grouped by ``key_of_item`` (an array over items) with
    the sum of their extended sales price: (keys, sums) per channel."""
    out = []
    for fact in ("store_sales", "catalog_sales", "web_sales"):
        rows = _fact_rows(t, fact, [year])
        items = t[fact][_fact(t, fact)[2]][rows]
        ok = keep_item[items]
        (key, ), inv = _gby([key_of_item[items][ok]])
        out.append((key, _gsum(inv, t[fact][_PRICE[fact]][rows][ok])))
    return out


def _channels_total(t, key_of_item, keep_item):
    chans = _channel_sums(t, key_of_item, keep_item)
    (key, ), inv = _gby([np.concatenate([k for k, _ in chans])])
    return key, _gsum(inv, np.concatenate([s for _, s in chans]))


def tpcds_q60_check(got, t):
    it = t["item"]
    key, tot = _channels_total(t, it["i_item_id"], it["i_category_id"] == 3)
    check_multiset(got, [key, tot], "q60")


def tpcds_q33_check(got, t):
    it = t["item"]
    manufacts = np.unique(it["i_manufact_id"][it["i_category_id"] == 3])
    key, tot = _channels_total(t, it["i_manufact_id"],
                               np.isin(it["i_manufact_id"], manufacts))
    check_multiset(got, [key, tot], "q33")


def tpcds_q58_check(got, t):
    it = t["item"]
    (si, s), (ci, c), (wi, w) = _channel_sums(
        t, it["i_item_id"], np.ones(len(it["i_item_id"]), dtype=bool))
    a, b = _pairs(*_codes((si, ci)))
    si, s, c = si[a], s[a], c[b]
    a, b = _pairs(*_codes((si, wi)))
    si, s, c, w = si[a], s[a], c[a], w[b]
    avg = (s + c + w) / 3.0
    keep = np.ones(len(si), dtype=bool)
    for v in (s, c, w):
        keep &= (v >= 0.5 * avg) & (v <= 2.0 * avg)
    check_multiset(got, [si[keep], s[keep], c[keep], w[keep], avg[keep]],
                   "q58")


def tpcds_q1_check(got, t):
    sr = t["store_returns"]
    rows = np.nonzero(_dim(t, "date_dim", "d_year",
                           sr["sr_returned_date_sk"]) == 2000)[0]
    (cu, st), inv = _gby([sr["sr_customer_sk"][rows],
                          sr["sr_store_sk"][rows]])
    total = _gsum(inv, sr["sr_return_amt"][rows])
    (_, ), sinv = _gby([st])
    avg = _gmean(sinv, total)[sinv] * 1.2
    keep = (total > avg) & (_dim(t, "store", "s_county", st) == "C1")
    c = t["customer"]
    check_multiset(got, [cu[keep], c["c_first_name"][cu[keep]],
                         c["c_last_name"][cu[keep]]], "q1")


def tpcds_q93_check(got, t):
    ss, sr = t["store_sales"], t["store_returns"]
    li, _ = _pairs(*_codes((ss["ss_ticket_number"], sr["sr_ticket_number"]),
                           (ss["ss_item_sk"], sr["sr_item_sk"])))
    price = ss["ss_sales_price"]
    qty = ss["ss_quantity"].astype(np.float64)
    matched = np.bincount(li, minlength=len(price)) > 0
    cust = np.concatenate([ss["ss_customer_sk"][li],
                           ss["ss_customer_sk"][~matched]])
    act = np.concatenate([price[li] * (qty[li] - 1),
                          price[~matched] * qty[~matched]])
    (cu, ), inv = _gby([cust])
    check_multiset(got, [cu, _gsum(inv, act)], "q93")


def tpcds_q69_check(got, t):
    s, w, c = (_channel_customers(t, f, 2000) for f in (
        "store_sales", "web_sales", "catalog_sales"))
    cust = t["customer"]
    keep = (np.isin(_dim(t, "customer_address", "ca_county",
                         cust["c_current_addr_sk"]), ["C1", "C2"])
            & np.isin(cust["c_customer_sk"],
                      np.setdiff1d(np.setdiff1d(s, w), c)))
    cd = cust["c_current_cdemo_sk"][keep]
    keys, inv = _gby([_dim(t, "customer_demographics", n, cd) for n in (
        "cd_gender", "cd_marital_status", "cd_education_status")])
    check_multiset(got, keys + [_gcount(inv)], "q69")


def tpcds_q65_check(got, t):
    ss = t["store_sales"]
    rows = _fact_rows(t, "store_sales", [1999])
    (st, it), inv = _gby([ss["ss_store_sk"][rows], ss["ss_item_sk"][rows]])
    rev = _gsum(inv, ss["ss_sales_price"][rows])
    (_, ), sinv = _gby([st])
    keep = rev <= 0.5 * _gmean(sinv, rev)[sinv]
    check_multiset(got, [_dim(t, "store", "s_store_name", st[keep]),
                         _dim(t, "item", "i_item_id", it[keep]), rev[keep]],
                   "q65")


def tpcds_q2_check(got, t):
    dd = t["date_dim"]
    ws, cs = t["web_sales"], t["catalog_sales"]
    d = np.concatenate([ws["ws_sold_date_sk"], cs["cs_sold_date_sk"]])
    price = np.concatenate([ws["ws_ext_sales_price"],
                            cs["cs_ext_sales_price"]])
    (y, w), inv = _gby([dd["d_year"][d], dd["d_dow"][d]])
    check_multiset(got, [y, w, _gsum(inv, price)], "q2")


def _rollup_levels(key_cols, value_cols, n_keys):
    """ROLLUP's levels in numpy: for each prefix of the keys, longest
    first, the prefix's groups (the other keys null) and the mean of each
    value column; the empty prefix is one row."""
    out = [[] for _ in range(len(key_cols) + len(value_cols))]
    for level in range(n_keys, -1, -1):
        if level:
            keys, inv = _gby(key_cols[:level])
            n = len(keys[0])
        else:
            keys, inv, n = [], np.zeros(len(key_cols[0]), dtype=np.int64), 1
        for i, k in enumerate(key_cols):
            out[i].append(_masked(keys[i], np.ones(n, dtype=bool))
                          if i < level else
                          _masked(np.full(n, "", dtype=object),
                                  np.zeros(n, dtype=bool)))
        for j, v in enumerate(value_cols):
            out[len(key_cols) + j].append(np.asarray(
                _gsum(inv, v, n) / np.maximum(_gcount(inv, n), 1)))
    return [np.ma.concatenate(parts) if i < len(key_cols)
            else np.concatenate(parts) for i, parts in enumerate(out)]


def tpcds_q27_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    cd = k["cd"]
    keep = ((_dim(t, "customer_demographics", "cd_gender", cd) == "M")
            & (_dim(t, "customer_demographics", "cd_marital_status", cd)
               == "S")
            & (_dim(t, "customer_demographics", "cd_education_status", cd)
               == "College")
            & (_dim(t, "date_dim", "d_year", k["d"]) == 2000))
    exp = _rollup_levels(
        [_dim(t, "item", "i_item_id", k["i"])[keep].astype(object),
         _dim(t, "store", "s_county", k["s"])[keep].astype(object)],
        [ss[c][keep] for c in ("ss_quantity", "ss_list_price",
                               "ss_coupon_amt", "ss_sales_price")], 2)
    check_multiset(got, exp, "q27")


def tpcds_q18_check(got, t):
    cs = t["catalog_sales"]
    cust = cs["cs_bill_customer_sk"]
    addr = _dim(t, "customer", "c_current_addr_sk", cust)
    keep = ((_dim(t, "customer_demographics", "cd_gender",
                  cs["cs_cdemo_sk"]) == "F")
            & (_dim(t, "customer_demographics", "cd_education_status",
                    cs["cs_cdemo_sk"]) == "College")
            & (_dim(t, "date_dim", "d_year", cs["cs_sold_date_sk"]) == 2000))
    exp = _rollup_levels(
        [_dim(t, "item", "i_item_id", cs["cs_item_sk"])[keep].astype(object),
         _dim(t, "customer_address", "ca_state", addr)[keep].astype(object),
         _dim(t, "customer_address", "ca_county", addr)[keep].astype(object)],
        [cs["cs_quantity"][keep], cs["cs_list_price"][keep]], 3)
    check_multiset(got, exp, "q18")


def tpcds_q15_check(got, t):
    cs = t["catalog_sales"]
    addr = _dim(t, "customer", "c_current_addr_sk", cs["cs_bill_customer_sk"])
    zips = _dim(t, "customer_address", "ca_zip", addr)
    d = cs["cs_sold_date_sk"]
    keep = ((_dim(t, "date_dim", "d_qoy", d) == 1)
            & (_dim(t, "date_dim", "d_year", d) == 2000)
            # every zip has five characters, so substr(ca_zip, 1, 5) is it
            & (np.isin(zips, TPCDS_ZIPS[:5])
               | np.isin(_dim(t, "customer_address", "ca_state", addr),
                         ["CA", "WA", "GA"])
               | (cs["cs_sales_price"] > 500)))
    (z, ), inv = _gby([zips[keep]])
    check_multiset(got, [z, _gsum(inv, cs["cs_sales_price"][keep])], "q15")


def tpcds_q25_check(got, t):
    ss, sr, cs = t["store_sales"], t["store_returns"], t["catalog_sales"]
    year = t["date_dim"]["d_year"]
    s_rows = np.nonzero(year[ss["ss_sold_date_sk"]] == 2000)[0]
    r_rows = np.nonzero(np.isin(year[sr["sr_returned_date_sk"]],
                                [2000, 2001]))[0]
    c_rows = np.nonzero(np.isin(year[cs["cs_sold_date_sk"]],
                                [2000, 2001]))[0]
    a, b = _pairs(*_codes(
        (ss["ss_customer_sk"][s_rows], sr["sr_customer_sk"][r_rows]),
        (ss["ss_item_sk"][s_rows], sr["sr_item_sk"][r_rows]),
        (ss["ss_ticket_number"][s_rows], sr["sr_ticket_number"][r_rows])))
    s_rows, r_rows2 = s_rows[a], r_rows[b]
    a, b = _pairs(*_codes(
        (sr["sr_customer_sk"][r_rows2], cs["cs_bill_customer_sk"][c_rows]),
        (sr["sr_item_sk"][r_rows2], cs["cs_item_sk"][c_rows])))
    s_rows, r_rows2, c_rows2 = s_rows[a], r_rows2[a], c_rows[b]
    keys, inv = _gby([
        _dim(t, "item", "i_item_id", ss["ss_item_sk"][s_rows]),
        _dim(t, "store", "s_store_name", ss["ss_store_sk"][s_rows])])
    check_multiset(got, keys + [
        _gsum(inv, ss["ss_net_profit"][s_rows]),
        _gsum(inv, sr["sr_net_loss"][r_rows2]),
        _gsum(inv, cs["cs_net_profit"][c_rows2])], "q25")


#: the 30/60/90/120-day buckets of q50 and q62 (``_LAG_EDGES``)
TPCDS_LAG_EDGES = [(None, 30), (30, 60), (60, 90), (90, 120), (120, None)]


def _lag_buckets(inv, lag):
    out = []
    for lo, hi in TPCDS_LAG_EDGES:
        mask = np.ones(len(lag), dtype=bool)
        if lo is not None:
            mask &= lag > lo
        if hi is not None:
            mask &= lag <= hi
        out.append(_gsum(inv, mask).astype(np.int64))
    return out


def tpcds_q50_check(got, t):
    ss, sr = t["store_sales"], t["store_returns"]
    a, b = _pairs(*_codes(
        (ss["ss_ticket_number"], sr["sr_ticket_number"]),
        (ss["ss_item_sk"], sr["sr_item_sk"]),
        (ss["ss_customer_sk"], sr["sr_customer_sk"])))
    ret = sr["sr_returned_date_sk"][b]
    keep = _dim(t, "date_dim", "d_year", ret) == 2000
    a, ret = a[keep], ret[keep]
    keys, inv = _gby([_dim(t, "store", "s_store_name",
                           ss["ss_store_sk"][a])])
    check_multiset(got, keys + _lag_buckets(
        inv, ret - ss["ss_sold_date_sk"][a]), "q50")


def tpcds_q61_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    keep = ((_dim(t, "date_dim", "d_year", k["d"]) == 2000)
            & (_dim(t, "store", "s_county", k["s"]) == "C1")
            & np.isin(_dim(t, "customer_address", "ca_county",
                           _dim(t, "customer", "c_current_addr_sk",
                                k["c"])), ["C1", "C2"])
            & (_dim(t, "item", "i_category_id", k["i"]) == 3))
    promo = keep & ((_dim(t, "promotion", "p_channel_email", k["p"]) == "Y")
                    | (_dim(t, "promotion", "p_channel_event", k["p"])
                       == "Y"))
    p = ss["ss_ext_sales_price"][promo].sum()
    tot = ss["ss_ext_sales_price"][keep].sum()
    check_multiset(got, _one_row(p, tot, p / tot * 100), "q61")


def tpcds_q62_check(got, t):
    ws = t["web_sales"]
    keep = _dim(t, "date_dim", "d_year", ws["ws_ship_date_sk"]) == 2000
    names = np.array([n[:20] for n in t["warehouse"]["w_warehouse_name"]])
    keys, inv = _gby([names[ws["ws_warehouse_sk"][keep]],
                      _dim(t, "ship_mode", "sm_type",
                           ws["ws_ship_mode_sk"][keep])])
    lag = ws["ws_ship_date_sk"][keep] - ws["ws_sold_date_sk"][keep]
    check_multiset(got, keys + _lag_buckets(inv, lag), "q62")


def tpcds_q71_check(got, t):
    dd = t["date_dim"]
    price, item, tm = [], [], []
    for fact, p, i, s in (
            ("web_sales", "ws_ext_sales_price", "ws_item_sk",
             "ws_sold_time_sk"),
            ("catalog_sales", "cs_ext_sales_price", "cs_item_sk",
             "cs_sold_time_sk"),
            ("store_sales", "ss_ext_sales_price", "ss_item_sk",
             "ss_sold_time_sk")):
        f = t[fact]
        d = f[_fact(t, fact)[0]]
        rows = (dd["d_moy"][d] == 11) & (dd["d_year"][d] == 1999)
        price.append(f[p][rows])
        item.append(f[i][rows])
        tm.append(f[s][rows])
    price, item, tm = (np.concatenate(x) for x in (price, item, tm))
    hour = _dim(t, "time_dim", "t_hour", tm)
    keep = ((_dim(t, "item", "i_manager_id", item) <= 20)
            & (hour >= 8) & (hour <= 10))
    keys, inv = _gby([_dim(t, "item", "i_brand_id", item[keep]),
                      _dim(t, "item", "i_brand", item[keep]), hour[keep],
                      _dim(t, "time_dim", "t_minute", tm[keep])])
    check_multiset(got, keys + [_gsum(inv, price[keep])], "q71")


def _q90_count(t, h0, h1):
    ws = t["web_sales"]
    hour = _dim(t, "time_dim", "t_hour", ws["ws_sold_time_sk"])
    return int(((hour >= h0) & (hour <= h1)
                & (_dim(t, "household_demographics", "hd_dep_count",
                        ws["ws_ship_hdemo_sk"]) == 3)).sum())


def tpcds_q90_check(got, t):
    check_multiset(got, _one_row(_q90_count(t, 7, 9) * 1.0
                                 / _q90_count(t, 17, 19)), "q90")


def tpcds_q92_check(got, t):
    ws = t["web_sales"]
    rows = _fact_rows(t, "web_sales", [2000])
    disc = ws["ws_ext_discount_amt"][rows]
    item = ws["ws_item_sk"][rows]
    (_, ), inv = _gby([item])
    thresh = _gmean(inv, disc)[inv] * 1.3
    keep = ((_dim(t, "item", "i_manufact_id", item) <= 30)
            & (disc > thresh))
    check_multiset(got, _one_row(disc[keep].sum()), "q92")


def _ws_order_stats(t, returned: bool):
    """q94 and q95's oracle: the year-2000 web orders shipped from a CA
    warehouse that ship from more than one warehouse, with (q95) or
    without (q94) a web return: distinct orders, and the sums of their
    shipping cost and net profit (null over no row)."""
    ws = t["web_sales"]
    order = ws["ws_order_number"]
    pairs = np.unique(np.stack([order, ws["ws_warehouse_sk"]]), axis=1)
    wh_per_order = np.bincount(pairs[0], minlength=int(order.max()) + 1)
    keep = ((_dim(t, "date_dim", "d_year", ws["ws_ship_date_sk"]) == 2000)
            & (_dim(t, "warehouse", "w_state", ws["ws_warehouse_sk"])
               == "CA")
            & (wh_per_order[order] > 1))
    is_ret = np.isin(order, t["web_returns"]["wr_order_number"])
    keep &= is_ret if returned else ~is_ret
    n = int(keep.sum())
    return [np.array([np.unique(order[keep]).size]),
            _masked([ws["ws_ext_ship_cost"][keep].sum() if n else 0.0],
                    [n > 0]),
            _masked([ws["ws_net_profit"][keep].sum() if n else 0.0],
                    [n > 0])]


def tpcds_q94_check(got, t):
    check_multiset(got, _ws_order_stats(t, returned=False), "q94")


def tpcds_q95_check(got, t):
    check_multiset(got, _ws_order_stats(t, returned=True), "q95")


def tpcds_q21_check(got, t):
    inv_t = t["inventory"]
    d = inv_t["inv_date_sk"]
    keep = (d >= 840) & (d <= 960)
    qty = inv_t["inv_quantity_on_hand"][keep].astype(np.int64)
    d = d[keep]
    keys, inv = _gby([
        _dim(t, "warehouse", "w_warehouse_name",
             inv_t["inv_warehouse_sk"][keep]),
        _dim(t, "item", "i_item_id", inv_t["inv_item_sk"][keep])])
    before = _gsum(inv, np.where(d < 900, qty, 0)).astype(np.int64)
    after = _gsum(inv, np.where(d >= 900, qty, 0)).astype(np.int64)
    sel = (before > 0) & (after * 3 >= before * 2) & (after * 2 <= before * 3)
    check_multiset(got, [k[sel] for k in keys] + [before[sel], after[sel]],
                   "q21")


def tpcds_q37_check(got, t):
    it, inv_t = t["item"], t["inventory"]
    price = it["i_current_price"]
    d, q = inv_t["inv_date_sk"], inv_t["inv_quantity_on_hand"]
    inv_items = inv_t["inv_item_sk"][(d >= 900) & (d <= 960) & (q >= 100)
                                     & (q <= 500)]
    keep = ((price >= 20) & (price <= 50) & (it["i_manufact_id"] <= 40)
            & np.isin(it["i_item_sk"], inv_items)
            & np.isin(it["i_item_sk"], t["catalog_sales"]["cs_item_sk"]))
    keys, _ = _gby([it["i_item_id"][keep], price[keep]])
    check_multiset(got, keys, "q37")


def tpcds_q40_check(got, t):
    cs, cr = t["catalog_sales"], t["catalog_returns"]
    a, b = _pairs(*_codes((cs["cs_order_number"], cr["cr_order_number"]),
                          (cs["cs_item_sk"], cr["cr_item_sk"])))
    matched = np.bincount(a, minlength=len(cs["cs_item_sk"])) > 0
    rows = np.concatenate([a, np.nonzero(~matched)[0]])
    refund = np.concatenate([cr["cr_refunded_cash"][b],
                             np.zeros(int((~matched).sum()))])
    item = cs["cs_item_sk"][rows]
    sold = cs["cs_sold_date_sk"][rows]
    price = _dim(t, "item", "i_current_price", item)
    keep = (price >= 20) & (price <= 70) & (sold >= 840) & (sold <= 960)
    net = (cs["cs_sales_price"][rows] - refund)[keep]
    sold = sold[keep]
    keys, inv = _gby([_dim(t, "warehouse", "w_state",
                           cs["cs_warehouse_sk"][rows][keep]),
                      _dim(t, "item", "i_item_id", item[keep])])
    check_multiset(got, keys + [_gsum(inv, np.where(sold < 900, net, 0.0)),
                                _gsum(inv, np.where(sold >= 900, net, 0.0))],
                   "q40")


def tpcds_q43_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    keep = _dim(t, "date_dim", "d_year", k["d"]) == 2000
    dow = _dim(t, "date_dim", "d_dow", k["d"])[keep]
    price = ss["ss_sales_price"][keep]
    keys, inv = _gby([_dim(t, "store", "s_store_name", k["s"])[keep]])
    check_multiset(got, keys + [_gsum(inv, np.where(dow == d, price, 0.0))
                                for d in range(7)], "q43")


def tpcds_q48_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    ms = _dim(t, "customer_demographics", "cd_marital_status", k["cd"])
    ed = _dim(t, "customer_demographics", "cd_education_status", k["cd"])
    st = _dim(t, "customer_address", "ca_state", k["a"])
    price, profit = ss["ss_sales_price"], ss["ss_net_profit"]

    def between(v, lo, hi):
        return (v >= lo) & (v <= hi)
    demo = (((ms == "M") & (ed == "Advanced Degree")
             & between(price, 100.0, 150.0))
            | ((ms == "S") & (ed == "College") & between(price, 50.0, 100.0))
            | ((ms == "W") & (ed == "Secondary")
               & between(price, 0.0, 50.0)))
    addr = ((np.isin(st, ["CA", "WA"]) & between(profit, 0, 50))
            | (np.isin(st, ["GA", "TX"]) & between(profit, 50, 80))
            | (np.isin(st, ["NY", "OH"]) & between(profit, -20, 20)))
    keep = ((_dim(t, "date_dim", "d_year", k["d"]) == 2000) & demo & addr)
    check_multiset(got, _one_row(int(ss["ss_quantity"][keep].astype(
        np.int64).sum())), "q48")


def tpcds_q26_check(got, t):
    cs = t["catalog_sales"]
    cd, p = cs["cs_cdemo_sk"], cs["cs_promo_sk"]
    keep = ((_dim(t, "customer_demographics", "cd_gender", cd) == "F")
            & (_dim(t, "customer_demographics", "cd_marital_status", cd)
               == "S")
            & (_dim(t, "customer_demographics", "cd_education_status", cd)
               == "College")
            & ((_dim(t, "promotion", "p_channel_email", p) == "N")
               | (_dim(t, "promotion", "p_channel_event", p) == "N"))
            & (_dim(t, "date_dim", "d_year", cs["cs_sold_date_sk"]) == 2000))
    keys, inv = _gby([_dim(t, "item", "i_item_id", cs["cs_item_sk"][keep])])
    check_multiset(got, keys + [_gmean(inv, cs[c][keep]) for c in (
        "cs_quantity", "cs_list_price", "cs_sales_price")], "q26")


def _inv_cov(t, moy):
    """q39's CTE in numpy: per (warehouse, item) of the inventory rows of
    2000's month ``moy``, the mean and the sample standard deviation over
    the mean (two passes; a group of one row has none), kept above 0.5."""
    inv_t = t["inventory"]
    d = inv_t["inv_date_sk"]
    keep = ((_dim(t, "date_dim", "d_year", d) == 2000)
            & (_dim(t, "date_dim", "d_moy", d) == moy))
    q = inv_t["inv_quantity_on_hand"][keep].astype(np.float64)
    (w, i), inv = _gby([inv_t["inv_warehouse_sk"][keep],
                        inv_t["inv_item_sk"][keep]])
    n = _gcount(inv)
    mean = _gsum(inv, q) / n
    with np.errstate(divide="ignore", invalid="ignore"):
        std = np.sqrt(_gsum(inv, (q - mean[inv]) ** 2) / (n - 1))
        cov = np.where(n > 1, std / mean, np.nan)
        sel = cov > 0.5
    return w[sel], i[sel], mean[sel], cov[sel]


def tpcds_q39_check(got, t):
    w1, i1, m1, c1 = _inv_cov(t, 4)
    w2, i2, m2, c2 = _inv_cov(t, 5)
    a, b = _pairs(*_codes((w1, w2), (i1, i2)))
    check_multiset(got, [w1[a], i1[a], m1[a], c1[a], m2[b], c2[b]], "q39")


def tpcds_df_q3(sess, t, F, Window):
    """The rig's ``_tpcds_q3`` (``testing/scaletest.py:418``)."""
    ss = sess.create_dataframe(t["store_sales"], num_partitions=4)
    dd = sess.create_dataframe(t["date_dim"], num_partitions=2)
    it = sess.create_dataframe(t["item"], num_partitions=2)
    return (ss.join(dd, ss.ss_sold_date_sk == dd.d_date_sk)
            .join(it, ss.ss_item_sk == it.i_item_sk)
            .filter((it.i_manufact_id == 7) & (dd.d_moy == 11))
            .groupBy("d_year", "i_brand_id")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("sum_agg"))
            .orderBy("d_year", "i_brand_id"))


def tpcds_df_q7(sess, t, F, Window):
    """The rig's ``_tpcds_q7`` (``testing/scaletest.py:443``)."""
    ss = sess.create_dataframe(t["store_sales"], num_partitions=4)
    cd = sess.create_dataframe(t["customer_demographics"], num_partitions=2)
    dd = sess.create_dataframe(t["date_dim"], num_partitions=2)
    it = sess.create_dataframe(t["item"], num_partitions=2)
    pr = sess.create_dataframe(t["promotion"], num_partitions=2)
    return (ss.join(cd, ss.ss_cdemo_sk == cd.cd_demo_sk)
            .join(dd, ss.ss_sold_date_sk == dd.d_date_sk)
            .join(it, ss.ss_item_sk == it.i_item_sk)
            .join(pr, ss.ss_promo_sk == pr.p_promo_sk)
            .filter((cd.cd_gender == "M")
                    & (cd.cd_marital_status == "S")
                    & (cd.cd_education_status == "College")
                    & ((pr.p_channel_email == "N")
                       | (pr.p_channel_event == "N"))
                    & (dd.d_year == 2000))
            .groupBy("i_item_sk")
            .agg(F.avg(F.col("ss_quantity")).alias("agg1"),
                 F.avg(F.col("ss_list_price")).alias("agg2"),
                 F.avg(F.col("ss_coupon_amt")).alias("agg3"),
                 F.avg(F.col("ss_ext_sales_price")).alias("agg4"))
            .orderBy("i_item_sk"))


def tpcds_df_q19(sess, t, F, Window):
    """The rig's ``_tpcds_q19`` (``testing/scaletest.py:490``)."""
    ss = sess.create_dataframe(t["store_sales"], num_partitions=4)
    dd = sess.create_dataframe(t["date_dim"], num_partitions=2)
    it = sess.create_dataframe(t["item"], num_partitions=2)
    return (dd.join(ss, ss.ss_sold_date_sk == dd.d_date_sk)
            .join(it, ss.ss_item_sk == it.i_item_sk)
            .filter((it.i_manager_id == 8) & (dd.d_moy == 11)
                    & (dd.d_year == 1999))
            .groupBy("i_brand_id")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("ext_price"))
            .orderBy(F.col("ext_price").desc(), "i_brand_id"))


def tpcds_df_q42(sess, t, F, Window):
    """The rig's ``_tpcds_q42`` (``testing/scaletest.py:518``)."""
    ss = sess.create_dataframe(t["store_sales"], num_partitions=4)
    dd = sess.create_dataframe(t["date_dim"], num_partitions=2)
    it = sess.create_dataframe(t["item"], num_partitions=2)
    return (dd.join(ss, ss.ss_sold_date_sk == dd.d_date_sk)
            .join(it, ss.ss_item_sk == it.i_item_sk)
            .filter((dd.d_moy == 12) & (dd.d_year == 2000))
            .groupBy("d_year", "i_category_id")
            .agg(F.sum(F.col("ss_ext_sales_price")).alias("total"))
            .orderBy(F.col("total").desc(), "d_year", "i_category_id"))


def tpcds_df_q89(sess, t, F, Window):
    """The rig's ``_tpcds_q89_window`` (``testing/scaletest.py:545``)."""
    ss = sess.create_dataframe(t["store_sales"], num_partitions=4)
    dd = sess.create_dataframe(t["date_dim"], num_partitions=2)
    it = sess.create_dataframe(t["item"], num_partitions=2)
    monthly = (dd.join(ss, ss.ss_sold_date_sk == dd.d_date_sk)
               .join(it, ss.ss_item_sk == it.i_item_sk)
               .filter(dd.d_year == 2000)
               .groupBy("i_category_id", "d_moy")
               .agg(F.sum(F.col("ss_ext_sales_price")).alias("rev")))
    w = Window.partitionBy("i_category_id")
    return (monthly
            .withColumn("avg_rev", F.avg(F.col("rev")).over(w))
            .filter(F.col("rev") > F.col("avg_rev"))
            .orderBy("i_category_id", "d_moy"))


def _in_order(got, exp, label):
    """The rig's ordered checks: each named column of ``exp`` equal
    (``np.array_equal``) or, for floats, ``np.allclose``, row by row."""
    for name, want in exp.items():
        data, _ = _col(got, name)
        want = np.asarray(want)
        same = (len(data) == len(want)) and (
            np.allclose(data, want) if want.dtype.kind == "f"
            else np.array_equal(data, want))
        if not same:
            raise AssertionError(f"{label}: column {name} differs")


def tpcds_df_q3_check(got, t):
    k = _ss_dims(t)
    keep = ((_dim(t, "item", "i_manufact_id", k["i"]) == 7)
            & (_dim(t, "date_dim", "d_moy", k["d"]) == 11))
    (y, b), s = _ss_sum_by(t, keep, [_dim(t, "date_dim", "d_year", k["d"]),
                                     _dim(t, "item", "i_brand_id", k["i"])],
                           "ss_ext_sales_price")
    _in_order(got, {"d_year": y, "i_brand_id": b, "sum_agg": s}, "q3 df")


def tpcds_df_q7_check(got, t):
    ss, k = t["store_sales"], _ss_dims(t)
    cd, p = k["cd"], k["p"]
    keep = ((_dim(t, "customer_demographics", "cd_gender", cd) == "M")
            & (_dim(t, "customer_demographics", "cd_marital_status", cd)
               == "S")
            & (_dim(t, "customer_demographics", "cd_education_status", cd)
               == "College")
            & ((_dim(t, "promotion", "p_channel_email", p) == "N")
               | (_dim(t, "promotion", "p_channel_event", p) == "N"))
            & (_dim(t, "date_dim", "d_year", k["d"]) == 2000))
    (items, ), inv = _gby([k["i"][keep]])
    exp = {"i_item_sk": items}
    for name, c in (("agg1", "ss_quantity"), ("agg2", "ss_list_price"),
                    ("agg3", "ss_coupon_amt"),
                    ("agg4", "ss_ext_sales_price")):
        exp[name] = _gmean(inv, ss[c][keep])
    _in_order(got, exp, "q7 df")


def tpcds_df_q19_check(got, t):
    k = _ss_dims(t)
    d = k["d"]
    keep = ((_dim(t, "item", "i_manager_id", k["i"]) == 8)
            & (_dim(t, "date_dim", "d_moy", d) == 11)
            & (_dim(t, "date_dim", "d_year", d) == 1999))
    (b, ), s = _ss_sum_by(t, keep, [_dim(t, "item", "i_brand_id", k["i"])],
                          "ss_ext_sales_price")
    perm = np.lexsort((b, -s))
    _in_order(got, {"i_brand_id": b[perm], "ext_price": s[perm]}, "q19 df")


def tpcds_df_q42_check(got, t):
    k = _ss_dims(t)
    d = k["d"]
    keep = ((_dim(t, "date_dim", "d_moy", d) == 12)
            & (_dim(t, "date_dim", "d_year", d) == 2000))
    (y, c), s = _ss_sum_by(t, keep, [_dim(t, "date_dim", "d_year", d),
                                     _dim(t, "item", "i_category_id",
                                          k["i"])], "ss_ext_sales_price")
    perm = np.lexsort((c, y, -s))
    _in_order(got, {"i_category_id": c[perm], "total": s[perm]}, "q42 df")


def tpcds_df_q89_check(got, t):
    k = _ss_dims(t)
    keep = _dim(t, "date_dim", "d_year", k["d"]) == 2000
    (c, m), rev = _ss_sum_by(t, keep, [_dim(t, "item", "i_category_id",
                                            k["i"]),
                                       _dim(t, "date_dim", "d_moy", k["d"])],
                             "ss_ext_sales_price")
    (_, ), cinv = _gby([c])
    avg = _gmean(cinv, rev)[cinv]
    sel = rev > avg
    _in_order(got, {"i_category_id": c[sel], "d_moy": m[sel],
                    "rev": rev[sel], "avg_rev": avg[sel]}, "q89 df")


#: (name, text, numpy oracle): ``testing/tpcds_queries.py``'s QUERY_SET
TPCDS_QUERIES = [
    ("q34_ticket_counts", TPCDS_Q34, tpcds_q34_check),
    ("q42_category_rev_sql", TPCDS_Q42, tpcds_q42_check),
    ("q52_brand_rev", TPCDS_Q52, tpcds_q52_check),
    ("q53_manufact_window", TPCDS_Q53, tpcds_q53_check),
    ("q55_brand_rev_mgr", TPCDS_Q55, tpcds_q55_check),
    ("q59_weekly_ratio", TPCDS_Q59, tpcds_q59_check),
    ("q68_city_tickets", TPCDS_Q68, tpcds_q68_check),
    ("q73_ticket_counts", TPCDS_Q73, tpcds_q73_check),
    ("q79_amt_profit", TPCDS_Q79, tpcds_q79_check),
    ("q88_time_buckets", TPCDS_Q88, tpcds_q88_check),
    ("q96_time_count", TPCDS_Q96, tpcds_q96_check),
    ("q98_revenue_ratio", TPCDS_Q98, tpcds_q98_check),
    ("q1_returns_corr_subq", TPCDS_Q1, tpcds_q1_check),
    ("q2_weekly_channels", TPCDS_Q2, tpcds_q2_check),
    ("q11_yoy_ratio", TPCDS_Q11, tpcds_q11_check),
    ("q27_rollup", TPCDS_Q27, tpcds_q27_check),
    ("q31_county_growth", TPCDS_Q31, tpcds_q31_check),
    ("q38_intersect", TPCDS_Q38, tpcds_q38_check),
    ("q60_three_channels", TPCDS_Q60, tpcds_q60_check),
    ("q65_low_revenue", TPCDS_Q65, tpcds_q65_check),
    ("q69_channel_gap", TPCDS_Q69, tpcds_q69_check),
    ("q87_except", TPCDS_Q87, tpcds_q87_check),
    ("q93_returns_net", TPCDS_Q93, tpcds_q93_check),
    ("q97_full_outer", TPCDS_Q97, tpcds_q97_check),
    ("q15_zip_or_filter", TPCDS_Q15, tpcds_q15_check),
    ("q25_fact_chain", TPCDS_Q25, tpcds_q25_check),
    ("q33_in_subq_channels", TPCDS_Q33, tpcds_q33_check),
    ("q50_return_lag", TPCDS_Q50, tpcds_q50_check),
    ("q61_promo_ratio", TPCDS_Q61, tpcds_q61_check),
    ("q62_ship_lag", TPCDS_Q62, tpcds_q62_check),
    ("q71_brand_time", TPCDS_Q71, tpcds_q71_check),
    ("q90_am_pm", TPCDS_Q90, tpcds_q90_check),
    ("q92_excess_discount", TPCDS_Q92, tpcds_q92_check),
    ("q94_multi_warehouse", TPCDS_Q94, tpcds_q94_check),
    ("q21_inventory_ratio", TPCDS_Q21, tpcds_q21_check),
    ("q37_inventory_window", TPCDS_Q37, tpcds_q37_check),
    ("q40_returns_split", TPCDS_Q40, tpcds_q40_check),
    ("q43_dow_pivot", TPCDS_Q43, tpcds_q43_check),
    ("q48_or_of_ands", TPCDS_Q48, tpcds_q48_check),
    ("q95_cte_in_chains", TPCDS_Q95, tpcds_q95_check),
    ("q18_rollup3", TPCDS_Q18, tpcds_q18_check),
    ("q26_catalog_demo", TPCDS_Q26, tpcds_q26_check),
    ("q39_inventory_cov", TPCDS_Q39, tpcds_q39_check),
    ("q58_revenue_bands", TPCDS_Q58, tpcds_q58_check),
]

#: (name, query builder, numpy check): the rig's five TPC-DS DataFrame
#: shapes (``testing/scaletest.py:418-589``)
TPCDS_DF_QUERIES = [
    ("tpcds_q3_star_join", tpcds_df_q3, tpcds_df_q3_check),
    ("tpcds_q7_star4_avgs", tpcds_df_q7, tpcds_df_q7_check),
    ("tpcds_q19_brand_rev", tpcds_df_q19, tpcds_df_q19_check),
    ("tpcds_q42_cat_rev", tpcds_df_q42, tpcds_df_q42_check),
    ("tpcds_q89_window_join", tpcds_df_q89, tpcds_df_q89_check),
]

#: the mixed DISTINCT queries, run twice and held to the same bits
TPCDS_RERUN = ("q94_multi_warehouse", "q95_cte_in_chains")


def register_tpcds_views(sess, t) -> None:
    """``tpcds_queries.register_views``: store_sales a view at 4
    partitions, every other table at 2."""
    for name, cols in t.items():
        sess.create_dataframe(
            cols, num_partitions=4 if name == "store_sales" else 2
        ).createOrReplaceTempView(name)


def run_tpcds_queries(srt, K, torch, tpcds, by_path, err) -> dict:
    """Phase 3j: the 44 TPC-DS SQL queries through ``session.sql`` over
    the views, default configuration, then the five DataFrame shapes over
    their own scans; each held against the numpy copy of its oracle, its
    hand-kernel calls replayed against the plain versions and its joins
    reported.  q40 must plan hash joins and no nested-loop join over more
    than one build row; q94 and q95 run twice and must give the same
    bits.  Returns each query's run (the query, cold seconds, launches,
    joins, rows)."""
    from spark_rapids_tpu_torch.sql import Window
    from spark_rapids_tpu_torch.sql import functions as F
    phase("3j", f"the scale rig's 44 TPC-DS SQL queries and five "
        f"DataFrame shapes, TPC-DS near SF1 ({TPCDS_ROWS} store_sales rows, "
        f"seed {TPCDS_SEED}), store_sales at 4 partitions and the other 18 "
        "tables at 2, default configuration")
    sess = srt.session()
    t0 = time.perf_counter()
    register_tpcds_views(sess, tpcds)
    log(f"  views registered in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {len(next(iter(v.values())))}"
                    for k, v in tpcds.items()))
    runs = {}
    queries = ([(name, SqlQuery(sess, text), check)
                for name, text, check in TPCDS_QUERIES]
               + [(name, build(sess, tpcds, F, Window), check)
                  for name, build, check in TPCDS_DF_QUERIES])
    for name, query, check in queries:
        t_query = time.perf_counter()
        q_seg: dict = {}
        q_mm: list = []
        with recording_seg_sums(K, q_seg), \
                recording(K, "murmur3_long", q_mm):
            got, launches, cold_s = drive(f"tpcds {name}", query.collect,
                                          K, torch, (), by_path)
        check_later(f"tpcds {name}", check, got, tpcds)
        for kname in SEG_SUM_BUILDS:
            if q_seg[kname]:
                err[kname] = max(err[kname], check_seg_sum_calls(
                    K, torch, kname, f"tpcds {name}", q_seg[kname]))
        if q_mm:
            err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
                K, torch, f"tpcds {name}", q_mm))
        del q_seg, q_mm
        joins = join_report(sess.last_plan)
        log(f"  tpcds {name}: {got.num_rows} rows (held against the numpy "
            f"copy of its oracle in the background); joins "
            f"{json.dumps(joins)}")
        if name == "q40_returns_split":
            wide = [j for j in joins if j.get("build_rows", 0) > 1]
            if wide or not any("build_rows" not in j for j in joins):
                raise AssertionError(f"q40 plans no hash join or a nested-"
                                     f"loop join over several rows: {joins}")
        if name in TPCDS_RERUN:
            other = query.collect()
            for a, b, label in zip(got.datas + got.validities,
                                   other.datas + other.validities,
                                   got.column_names * 2):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name}: the rerun differs in "
                                         f"{label}")
            log(f"  tpcds {name}: the same bits on a rerun")
        runs[name] = dict(query=query, cold_s=cold_s, launches=launches,
                          joins=joins, rows=got.num_rows)
        log(f"  tpcds {name}: run, checks and replays took "
            f"{time.perf_counter() - t_query:.2f} s")
    totals = {k: sum(r["launches"][k] for r in runs.values())
              for k in RIG_KERNELS}
    log(f"  the TPC-DS queries' launches of the hand kernels: {totals}")
    for k, n in totals.items():
        if n < 1:
            raise AssertionError(f"no TPC-DS query launched {k}")
    return runs


def tpcds_times(runs: dict, torch) -> list:
    """Phase 4's part for phase 3j: each query cold, warm (one run after
    the cold one) and profiled once; printed as the ``tpcds`` JSON line."""
    log("  the 44 TPC-DS SQL queries and five DataFrame shapes: cold, warm "
        "(one run after the cold one), a profile of one warm run of "
        f"{PROFILED['tpcds']}; each SQL run parses and plans anew")
    report = []
    for qname, rr in runs.items():
        t_query = time.perf_counter()
        wm, tms = warm_ms(rr["query"], torch, WARM_RUNS_3I_3J)
        log(f"  tpcds {qname}: cold {rr['cold_s'] * 1e3:.3f} ms; warm median "
            f"{wm:.3f} ms of {[round(t, 3) for t in tms]} ms")
        report.append({
            "query": qname, "rows": rr["rows"],
            "cold_ms": rr["cold_s"] * 1e3, "warm_ms": wm,
            **profile_fields("tpcds", qname, rr["query"], torch),
            "joins": rr["joins"],
            "launches": {k: rr["launches"][k] for k in RIG_KERNELS}})
        log(f"  tpcds {qname}: times took {time.perf_counter() - t_query:.2f}"
            " s")
    log(json.dumps({"tpcds": report}))
    return report


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


#: the port's record_function ranges (ops/hashing.py)
ANNOTATIONS = ("murmur3_bytes",)


def profile_fields(part: str, qname: str, query, torch, **kwargs) -> dict:
    """A light profile's fields of a phase 4 report entry where ``PROFILED``
    names the query, else None for each."""
    if qname not in PROFILED[part]:
        return {"profiled_wall_ms": None, "busy_ms": None,
                "busy_share": None}
    prof = profile_query(f"{part} {qname}", query, torch, top=6,
                         detail=False, **kwargs)
    return {"profiled_wall_ms": prof["wall_ms"], "busy_ms": prof["busy_ms"],
            "busy_share": prof["busy_ms"] / prof["wall_ms"]}


def profile_query(label: str, query, torch, top: int = 12,
                  forbid=("cummin", "cummax"), detail: bool = True):
    """Where one warm collect spends device time: torch.profiler over it,
    device time by op, and the device's busy share of the wall time.  Fails
    if any event, host op or kernel, names one of ``forbid`` (the running
    min and max scans, which the port no longer runs).  Returns the wall
    and busy ms and seg_sum2's segment_reduce ms, and with ``detail`` the
    float64 index_add_ kernels it saw, as (key, ms, count), and
    murmur3_bytes' calls, launches and device ms."""
    t_profile = time.perf_counter()
    try:
        return _profile_query(label, query, torch, top, forbid, detail)
    finally:
        secs = time.perf_counter() - t_profile
        PROFILE_SECONDS[0] += secs
        log(f"    the profile of {label} took {secs:.2f} s")


def _profile_query(label, query, torch, top, forbid, detail):
    from torch.profiler import ProfilerActivity, profile
    # without ``detail`` the device's events alone: a join-heavy query's
    # tens of thousands of host ops make the trace's processing take longer
    # than the query
    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if detail
                  else [ProfilerActivity.CUDA])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        query.collect()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not detail:
        return _device_profile(label, prof, wall_ms, top, forbid, torch)

    averages = prof.key_averages()
    banned = sorted({e.key for e in averages
                     if any(f in e.key for f in forbid)})
    if banned:
        raise AssertionError(f"{label}: the profile shows {banned}")

    def dev_us(e):
        if hasattr(e, "self_device_time_total"):
            return e.self_device_time_total
        return getattr(e, "self_cuda_time_total", 0.0)
    # device-side events only (kernels, copies): each is counted once; a
    # record_function range also shows as a device event spanning its
    # kernels, and is left out
    kernels = sorted((e for e in averages
                      if e.device_type != torch.autograd.DeviceType.CPU
                      and e.key not in ANNOTATIONS),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    log(f"  profiled warm {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}; wall includes "
        "profiler overhead)")
    for e in kernels[:top]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")
    # seg_sum2's fixed-order double sums: segment_reduce's kernel (its sort
    # of the ids is not counted here)
    seg_reduce_ms = sum(dev_us(e) for e in kernels
                        if "segment_reduce" in e.key) / 1e3
    log(f"    segment_reduce kernels (seg_sum2's double sums): "
        f"{seg_reduce_ms:.3f} ms")
    # the hand-written kernels, wherever they rank: device time alone,
    # without the host time of their wrappers
    for e in kernels:
        if "murmur3" in e.key or "seg_sum" in e.key:
            log(f"    hand kernel: {dev_us(e) / 1e3:.5f} ms  x{e.count} "
                f"{e.key[:100]}")
    # murmur3's launches one by one, longest first: the large maps' hashes
    # inside the query, with whatever L2 holds there
    each = sorted((dev_us(e) for e in prof.events()
                   if "murmur3" in e.name and e.name not in ANNOTATIONS
                   and e.device_type != torch.autograd.DeviceType.CPU),
                  reverse=True)
    if each:
        log(f"    murmur3 launches, device us, longest first: "
            f"{[round(u, 3) for u in each[:8]]}")
    # index_add_ runs as indexFuncSmallIndex / indexFuncLargeIndex<T, ...>
    f64_adds = [(e.key, dev_us(e) / 1e3, e.count) for e in kernels
                if "indexFunc" in e.key and "double" in e.key]
    for key, ms, count in f64_adds:
        log(f"    float64 index_add_: {ms:.3f} ms  x{count} {key[:100]}")
    log(f"    float64 index_add_ kernels: {len(f64_adds)}")
    # the string keys' byte hash: plain torch, marked with record_function
    mb_ms, mb_launches = range_kernels(prof, "murmur3_bytes")
    mb_calls = sum(e.count for e in prof.key_averages()
                   if e.key == "murmur3_bytes"
                   and e.device_type == torch.autograd.DeviceType.CPU)
    log(f"    murmur3_bytes: {mb_calls} calls, {mb_launches} kernel "
        f"launches, {mb_ms:.5f} ms of device time "
        f"({mb_ms / max(busy_ms, 1e-12):.2%} of the device busy time)")
    return {"f64_adds": f64_adds, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "seg_reduce_ms": seg_reduce_ms,
            "murmur3_bytes_ms": mb_ms, "murmur3_bytes_launches": mb_launches,
            "murmur3_bytes_calls": mb_calls}


def _device_profile(label: str, prof, wall_ms: float, top: int, forbid,
                    torch) -> dict:
    """``profile_query``'s light form: the device's events read straight
    from the trace (``kineto_results``), summed by kernel name, without
    ``key_averages``, whose parse of every event took 4 s a TPC-DS query
    (measured on one H100) and gives the same sums: a device event has no
    children, so its self time is its duration."""
    names: dict = {}
    for e in prof.profiler.kineto_results.events():
        # a record_function range shows as a device event spanning its
        # kernels, and is left out
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() == torch.autograd.DeviceType.CPU \
                or e.name() in ANNOTATIONS \
                or (annotation is not None and annotation()):
            continue
        ns, count = names.get(e.name(), (0, 0))
        names[e.name()] = (ns + e.duration_ns(), count + 1)
    banned = sorted(n for n in names if any(f in n for f in forbid))
    if banned:
        raise AssertionError(f"{label}: the profile shows {banned}")
    busy_ms = sum(ns for ns, _ in names.values()) / 1e6
    log(f"  profiled warm {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}; wall includes "
        "profiler overhead)")
    for name, (ns, count) in sorted(names.items(), key=lambda kv: -kv[1][0]
                                    )[:top]:
        log(f"    {ns / 1e6:9.3f} ms  x{count:<4d} {name[:100]}")
    seg_reduce_ms = sum(ns for n, (ns, _) in names.items()
                        if "segment_reduce" in n) / 1e6
    log(f"    segment_reduce kernels (seg_sum2's double sums): "
        f"{seg_reduce_ms:.3f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "seg_reduce_ms": seg_reduce_ms}


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
    """Per-run times of the murmur3_long launches a main path made, each
    launch after an L2 flush (the plain version 5 iterations).  The totals
    also give the launches of at least 2^20 rows on their own (``big_*``),
    where the launch cost is amortised."""
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0,
                  big_ms=0.0, big_bound_ms=0.0,
                  big_launches=0)
    for values, seed in calls:
        n = values.shape[0]
        t = dict(ms=cuda_ms(lambda: K.murmur3_long(values, seed),
                            flush_l2=True),
                 plain_ms=cuda_ms(lambda: K.murmur3_long_plain(values, seed),
                                  iters=5, warmup=1, flush_l2=True),
                 bound_ms=murmur3_bytes(values, seed) / HBM_BYTES_PER_S * 1e3,
                 bytes=murmur3_bytes(values, seed))
        log(f"  murmur3_long n={n} "
            f"{'scalar' if isinstance(seed, int) else 'per-row'} seed: " +
            ", ".join(f"{k}={v:.5f}" for k, v in t.items() if k != "bytes")
            + f", share of bound {t['bound_ms'] / t['ms']:.1%}")
        for k in ("ms", "plain_ms", "bound_ms", "bytes"):
            totals[k] += t[k]
        if n >= 1 << 20:
            totals["big_ms"] += t["ms"]
            totals["big_bound_ms"] += t["bound_ms"]
            totals["big_launches"] += 1
    return totals


def murmur3_bytes_times(H, torch, calls, label: str):
    """The murmur3_bytes calls a main path made, replayed alone: device
    time per run (CUDA events around each call after an L2 flush), the
    device kernels of one replay of each (torch.profiler), and the bound
    its bytes set (the matrix, the lengths, a per-row seed and the hashes
    each moved once)."""
    from torch.profiler import ProfilerActivity, profile
    ms = bound = 0.0
    launches = 0
    for chars, lengths, seed in calls:
        ms += cuda_ms(lambda: H.murmur3_bytes(chars, lengths, seed),
                      iters=5, warmup=1, flush_l2=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            H.murmur3_bytes(chars, lengths, seed)
            torch.cuda.synchronize()
        launches += sum(1 for e in prof.events()
                        if e.device_type != torch.autograd.DeviceType.CPU
                        and "memcpy" not in e.name.lower()
                        and "memset" not in e.name.lower())
        rows, width = chars.shape
        moved = rows * (width + 4 + 4) + (4 * rows if not isinstance(
            seed, int) else 0)
        bound += moved / HBM_BYTES_PER_S * 1e3
    shapes = sorted({tuple(c.shape) for c, _, _ in calls})
    log(f"  murmur3_bytes per {label} run, replayed: {len(calls)} calls "
        f"(rows, width) {shapes}; {launches} kernel launches; "
        f"ms={ms:.5f}, bound_ms={bound:.5f}")
    return dict(ms=ms, launches=launches, bound_ms=bound, calls=len(calls))


def run(argv) -> int:
    """The mode ``argv`` names (the whole script when it names none); then
    every background check a mode left unread, so that none can pass
    unseen."""
    # a hang, or a cut just before the 1,200 s limit, leaves its stacks
    faulthandler.dump_traceback_later(1140, exit=False)
    rc = run_mode(argv)
    if CPU_SIDES:
        finish_cpu_sides()
    return rc


def run_mode(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script needs "
                    "an NVIDIA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "spark_rapids_tpu_torch")):
        return fail(f"no spark_rapids_tpu_torch package beside {__file__}")
    sys.path.insert(0, root)
    import spark_rapids_tpu_torch as srt
    from spark_rapids_tpu_torch.ops import hashing as H
    from spark_rapids_tpu_torch.ops import kernels as K
    from spark_rapids_tpu_torch.sql import functions as F

    # -- phase 1: device and build ------------------------------------------
    phase("1", "device and build")
    HOST_PROBE_AT_START.append(host_probe())
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
    phase("2", "kernels against their plain versions")
    def timed_check(name, check):
        t0 = time.perf_counter()
        out = check(K, torch)
        log(f"  {name}: checked in {time.perf_counter() - t0:.2f} s")
        return out
    timed_check("seg_sum", check_seg_sum)
    err = {"seg_sum_f32": 0.0, "seg_sum_f64": 0.0}
    for name, check in (("murmur3_long", check_murmur3),
                        ("pcg64", check_pcg64), ("md5", check_md5),
                        ("dtoa_shortest", check_dtoa)):
        err[name] = timed_check(name, check)
    err["dfa_search"] = err["dfa_match_spans"] = timed_check("dfa",
                                                             check_dfa)
    if "--kernels" in argv:
        log("phase 4 (kernels alone)")
        seg_sum_alone(K, torch)
        log("--kernels: phases 1 and 2 passed; the main paths were not run")
        return 0
    if "--sql" in argv:
        t0 = time.perf_counter()
        tpch = make_tpch_tables(SQL_LINEITEM)
        log(f"  tables generated in {time.perf_counter() - t0:.2f} s")
        sql_runs = run_sql_queries(srt, K, torch, tpch, {}, err)
        finish_cpu_sides()
        sql_times(sql_runs, torch)
        log("--sql: phases 1, 2 and 3i passed, and 3i's times; the other "
            "main paths were not run")
        return 0
    if "--decimal" in argv:
        t0 = time.perf_counter()
        tpch = make_tpch_tables(SQL_LINEITEM)
        log(f"  tables generated in {time.perf_counter() - t0:.2f} s")
        dec_runs = run_decimal_queries(srt, K, torch, tpch, {}, err)
        decimal_matrix(srt, torch)
        finish_cpu_sides()
        decimal_times(dec_runs, float_sql_warm(srt, torch, tpch), torch)
        log("--decimal: phases 1, 2 and 3k passed, and 3k's times; the other "
            "main paths were not run")
        return 0
    if "--tlc" in argv:
        started = start_tlc_matrix_cpu(srt)
        t0 = time.perf_counter()
        raw, truth = make_tlc_trips(TLC_ROWS)
        log(f"  trips generated in {time.perf_counter() - t0:.2f} s")
        tlc_runs = run_tlc_queries(srt, K, torch, raw, truth, {}, err)
        del raw, truth
        tlc_matrix(srt, torch, started)
        finish_cpu_sides()
        tlc_times(tlc_runs, torch)
        log("--tlc: phases 1, 2 and 3l passed, and 3l's times; the other "
            "main paths were not run")
        return 0
    if "--parquet" in argv:
        t0 = time.perf_counter()
        tpch = make_tpch_tables(SQL_LINEITEM)
        td = decimal_tpch_tables(tpch)
        fact = make_rig_tables(RIG_ROWS)["fact"]
        log(f"  tables generated in {time.perf_counter() - t0:.2f} s")
        pq_runs = parquet_phase(srt, K, torch, td, fact, {}, err)
        finish_cpu_sides()
        parquet_times(pq_runs["runs"], memory_decimal_warm(srt, torch, td),
                      torch)
        parquet_cleanup(pq_runs["root"])
        log("--parquet: phases 1, 2 and 3m passed, and 3m's times; the "
            "other main paths were not run")
        return 0
    if "--api" in argv:
        t0 = time.perf_counter()
        tpch = make_tpch_tables(SF1_LINEITEM)
        fact = make_rig_tables(RIG_ROWS)["fact"]
        root = parquet_root()
        srt.session().create_dataframe(fact, num_partitions=PARQUET_PARTS) \
            .write.parquet(os.path.join(root, "fact"))
        log(f"  tables generated and the fact table written in "
            f"{time.perf_counter() - t0:.2f} s")
        api = api_phase(srt, K, torch, tpch, fact, root, {}, err)
        finish_cpu_sides()
        api_times(api, K, torch)
        parquet_cleanup(root)
        log(json.dumps(phase_seconds()))
        log("--api: phases 1, 2 and 3o passed, and 3o's times; the other "
            "main paths were not run")
        return 0
    if "--strings" in argv:
        t0 = time.perf_counter()
        tpch = make_tpch_tables(SF1_LINEITEM)
        fact = make_rig_tables(RIG_ROWS)["fact"]
        log(f"  tables generated in {time.perf_counter() - t0:.2f} s")
        strings = strings_phase(srt, K, torch, tpch, fact, {}, err)
        finish_cpu_sides()
        phase("4 strings", "phase 3p's times and its four kernels")
        strings_times(strings, K, torch)
        log(json.dumps(phase_seconds()))
        log("--strings: phases 1, 2 and 3p passed, and 3p's times; the "
            "other main paths were not run")
        return 0
    if "--tpcds" in argv:
        t0 = time.perf_counter()
        tpcds = make_tpcds_tables(TPCDS_ROWS)
        log(f"  tables generated in {time.perf_counter() - t0:.2f} s")
        tpcds_runs = run_tpcds_queries(srt, K, torch, tpcds, {}, err)
        finish_cpu_sides()
        tpcds_times(tpcds_runs, torch)
        log("--tpcds: phases 1, 2 and 3j passed, and 3j's times; the other "
            "main paths were not run")
        return 0

    # -- phase 3: the main paths ----------------------------------------------
    #: main path -> kernel launches of its run
    by_path: dict = {}
    sess = srt.session()
    if sess.device.type != "cuda":
        raise AssertionError(f"session() chose {sess.device}, not cuda")
    phase("3a", f"q1 over {ROWS} rows in one partition on cuda")
    data = make_data(ROWS)
    want = q1_oracle(data)
    query = q1(sess.create_dataframe(data), F)
    seg_calls: dict = {}
    with recording_seg_sums(K, seg_calls):
        table, q1_launches, _ = drive(
            "q1, one partition", query.collect, K, torch,
            list(SEG_SUM_BUILDS), by_path)
    for name in SEG_SUM_BUILDS:
        err[name] = max(err[name], check_seg_sum_calls(
            K, torch, name, "q1, one partition", seg_calls[name]))
    check_result(table, want)
    for row in table.to_pylist():
        log(f"  {row}")
    log("  q1 matches the numpy oracle (keys and counts exact, doubles "
        f"rtol={RTOL_F64})")

    phase("3b", "q1 at 4 partitions, AQE on (default) and off")
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
                             torch, need, by_path)
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

    phase("3c", f"TPC-H Q18 inner aggregate at SF1 ({SF1_ORDERS} orders, "
        "4 partitions)")
    li, okeys, lines = make_lineitem(SF1_ORDERS)
    n_li = li["l_orderkey"].size
    want_keys, want_sums = q18_oracle(li, okeys, lines)
    q18 = q18_inner(sess.create_dataframe(li, num_partitions=4), F)
    mm_calls: list = []
    with recording(K, "murmur3_long", mm_calls):
        t18, _, _ = drive(
            f"Q18-inner, {n_li} lineitem rows", q18.collect, K, torch,
            ["murmur3_long"], by_path)
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

    phase("3d", "repartition(8, l_orderkey) and hash(l_orderkey)")
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

    phase("3e", f"TPC-H Q18 at SF1 ({SF1_CUSTOMERS} customers, "
        f"{SF1_ORDERS} orders, {n_li} lineitem rows, 4 partitions each)")
    cu, od = make_orders(okeys, SF1_CUSTOMERS)
    sums = np.bincount(np.repeat(np.arange(okeys.size), lines),
                       weights=li["l_quantity"])
    want18 = q18_full_oracle(cu, od, li, sums)
    full18 = q18_full(*(sess.create_dataframe(t, num_partitions=4)
                   for t in (cu, od, li)), F)
    from spark_rapids_tpu_torch.ops import bloom as BL
    bloom0 = dict(BL.STATS)
    q18_mm_calls: list = []
    q18_seg_calls: dict = {}
    need18 = ["murmur3_long"] + list(SEG_SUM_BUILDS)
    with recording(K, "murmur3_long", q18_mm_calls), \
            recording_seg_sums(K, q18_seg_calls):
        t_q18, q18_full_launches, q18_cold_s = drive(
            "Q18, default configuration", full18.collect, K, torch, need18,
            by_path)
    log("  Q18 bloom filters: " + ", ".join(
        f"{k} {BL.STATS[k] - bloom0[k]}" for k in BL.STATS))
    if BL.STATS["blooms_built"] - bloom0["blooms_built"] < 1 or \
            BL.STATS["probe_rows_kept"] - bloom0["probe_rows_kept"] > \
            BL.STATS["probe_rows_in"] - bloom0["probe_rows_in"]:
        raise AssertionError("Q18: no bloom filter over orders, or it kept "
                             "more rows than it saw")
    report_joins(sess.last_plan, "Q18", Q18_STRATEGIES)
    check_exact(t_q18, want18, "Q18")
    err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
        K, torch, "Q18", q18_mm_calls))
    for name in SEG_SUM_BUILDS:
        err[name] = max(err[name], check_seg_sum_calls(
            K, torch, name, "Q18", q18_seg_calls[name]))
    del q18_seg_calls
    log(f"  Q18 matches the numpy oracle exactly: {t_q18.num_rows} rows, "
        f"first {t_q18.to_pylist()[:2]}")
    # under the defaults the final aggregate's exchange coalesces (AQE:
    # its 57 partial rows are under minRows), so it hashes nothing; at
    # minRows 0 it hashes c_name's bytes first, and the keys after it chain
    # per-row seeds through the kernel
    s_split = srt.session(conf={
        "spark.sql.adaptive.coalescePartitions.minRows": 0})
    split18 = q18_full(*(s_split.create_dataframe(t, num_partitions=4)
                         for t in (cu, od, li)), F)
    q18_split_mm: list = []
    q18_mb_calls: list = []
    with recording(K, "murmur3_long", q18_split_mm), \
            recording(H, "murmur3_bytes", q18_mb_calls):
        t_split, _, _ = drive("Q18, minRows 0", split18.collect, K, torch,
                              need18, by_path)
    report_joins(s_split.last_plan, "Q18, minRows 0", Q18_STRATEGIES)
    check_exact(t_split, want18, "Q18, minRows 0")
    err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
        K, torch, "Q18, minRows 0", q18_split_mm))
    if not q18_mb_calls or not any(not isinstance(sd, int)
                                   for _, sd in q18_split_mm):
        raise AssertionError("Q18 at minRows 0: no murmur3_bytes of c_name "
                             "and no per-row seeded murmur3_long after it")
    log(f"  Q18 at minRows 0 matches too: murmur3_bytes {len(q18_mb_calls)}"
        " calls (c_name), then murmur3_long with per-row seeds")
    del t_split
    cu_nn = {"c_custkey": cu["c_custkey"]}
    nn18 = q18_full(*(sess.create_dataframe(t, num_partitions=4)
                      for t in (cu_nn, od, li)), F, names=False)
    t_nn, _, q18_nn_cold_s = drive("Q18 without c_name", nn18.collect, K,
                                   torch, need18, by_path)
    report_joins(sess.last_plan, "Q18 without c_name", Q18_STRATEGIES)
    check_exact(t_nn, q18_full_oracle(cu, od, li, sums, names=False),
                "Q18 without c_name")
    log("  Q18 without c_name (the port's Q18 before strings) matches too")
    del t_nn

    s_bc = srt.session(conf={"spark.rapids.sql.autoBroadcastJoinThreshold":
                             Q18_BROADCAST_THRESHOLD})
    bc18 = q18_full(*(s_bc.create_dataframe(t, num_partitions=4)
                 for t in (cu, od, li)), F)
    t_bc, _, _ = drive(f"Q18, broadcast threshold {Q18_BROADCAST_THRESHOLD}",
                       bc18.collect, K, torch, ["murmur3_long"])
    report_joins(s_bc.last_plan, "Q18 (32 MiB threshold)",
                 Q18_BROADCAST_STRATEGIES)
    check_exact(t_bc, want18, "Q18 (32 MiB threshold)")
    log("  Q18 with the semi join broadcast matches the oracle too")
    del s_bc, bc18, t_bc

    median = float(np.median(od["o_totalprice"]))
    keep_keys = od["o_orderkey"][od["o_totalprice"] > median]
    df_l = sess.create_dataframe(li, num_partitions=4)
    df_o = sess.create_dataframe(od, num_partitions=4)
    df_o = df_o.filter(F.col("o_totalprice") > median)
    for how in JOIN_TYPES:
        joined = df_l.join(df_o, df_l["l_orderkey"] == df_o["o_orderkey"],
                           how)
        out, _, _ = drive(f"lineitem {how} orders(price > median)",
                          joined.collect, K, torch)
        lk = out.column("l_orderkey")
        got = (out.num_rows, int(np.ma.getdata(lk)[~np.ma.getmaskarray(
            lk)].sum()), 0)
        if how not in ("left_semi", "left_anti"):
            ok = out.column("o_orderkey")
            got = got[:2] + (int(np.ma.getdata(ok)[~np.ma.getmaskarray(
                ok)].sum()),)
        want = join_matrix_oracle(li, keep_keys, how)
        from spark_rapids_tpu_torch.sql.physical.join import \
            join_strategies
        log(f"    {how}: rows {got[0]}, key sums {got[1:]}; strategy "
            f"{join_strategies(sess.last_plan)}")
        if got != want:
            raise AssertionError(f"lineitem {how} orders: (rows, key sums) "
                                 f"{got}, numpy {want}")
        del out, joined
    log("  the six join types match numpy's row counts and key sums")

    from spark_rapids_tpu_torch.sql import Window
    phase("3f", f"windows. Path 1, bench.py's running sum over {ROWS} "
        "rows, 4 partitions")
    wdata = make_window_data(ROWS)
    rs_want = running_sum_oracle(wdata)
    total_want = float(rs_want.sum())
    scale = prefix_scale(K, torch, wdata, 4)
    need_w1 = ["murmur3_long"] + list(SEG_SUM_BUILDS)
    w1_runs = {}
    for target in (None, WINDOW_SMALL_TARGET):
        conf = None if target is None else {
            "spark.rapids.sql.window.batchTargetRows": target}
        label = ("path 1" if target is None
                 else f"path 1, batchTargetRows {target}")
        sw = srt.session(conf=conf)
        dfw = sw.create_dataframe(wdata, num_partitions=4)
        total_q = window_total(dfw, F, Window)
        mm_w1: list = []
        seg_w1: dict = {}
        with recording(K, "murmur3_long", mm_w1), \
                recording_seg_sums(K, seg_w1):
            tw, _, w1_cold_s = drive(label, total_q.collect, K, torch,
                                     need_w1, by_path)
        from spark_rapids_tpu_torch.sql.physical.window import WindowExec
        (wexec,) = [n for n in walk(sw.last_plan) if isinstance(n,
                                                                 WindowExec)]
        (hx,) = exchanges_of(wexec)
        log(f"  {label} plan: " + " <- ".join(
            ln.strip() for ln in sw.explain().splitlines()))
        log(f"  {label}: window exchange coalesced={hx.coalesced} "
            f"rows_partitioned={hx.rows_partitioned}; key-complete chunks "
            f"{wexec.key_batches}")
        if hx.coalesced is not False or hx.rows_partitioned != ROWS:
            raise AssertionError(f"{label}: the window's exchange did not "
                                 "hash every row")
        total = tw.column("total")
        if tw.num_rows != 1 or np.ma.getmaskarray(total).any():
            raise AssertionError(f"{label}: no total")
        np.testing.assert_allclose(np.ma.getdata(total), [total_want],
                                   rtol=RTOL_F64, err_msg=label)
        log(f"  {label}: total {float(total[0])!r} vs numpy "
            f"{total_want!r} (rtol {RTOL_F64})")
        err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
            K, torch, label, mm_w1))
        for name in SEG_SUM_BUILDS:
            err[name] = max(err[name], check_seg_sum_calls(
                K, torch, name, label, seg_w1[name]))
        rs_table, _, _ = drive(f"{label}, rs collected", running_sum(
            dfw, F, Window).collect, K, torch, ["murmur3_long"])
        check_running_sums(rs_table, wdata, rs_want, scale, label)
        del rs_table
        w1_runs[label] = dict(query=total_q, cold_s=w1_cold_s, mm=mm_w1,
                              seg=seg_w1, chunks=wexec.key_batches)
    # one chunk per reduce partition at the default target; more than four
    # per partition at the small one
    chunks = [r["chunks"] for r in w1_runs.values()]
    if chunks[0] != 4 or chunks[1] <= 4 * 4:
        raise AssertionError(f"path 1: key-complete chunks {chunks}")

    log(f"  path 2: rank() <= 1 per order over the SF1 lineitem ({n_li} "
        "rows, 4 partitions)")
    keys_want, qty_want = top_line_oracle(li, lines)
    top_q = rank_top_line(sess.create_dataframe(li, num_partitions=4), F,
                          Window)
    mm_w2: list = []
    with recording(K, "murmur3_long", mm_w2):
        t_top, w2_launches, w2_cold_s = drive("path 2", top_q.collect, K,
                                              torch, ["murmur3_long"],
                                              by_path)
    log("  path 2 plan: " + " <- ".join(
        ln.strip() for ln in sess.explain().splitlines()))
    if not exchange_above_group_limit(sess.last_plan):
        raise AssertionError("path 2: no WindowGroupLimitExec below the "
                             "window's exchange")
    (hx2,) = exchanges_of(sess.last_plan)
    log(f"  path 2 exchange: coalesced={hx2.coalesced} rows_partitioned="
        f"{hx2.rows_partitioned} (of {n_li} lineitem rows)")
    got_k = np.ma.getdata(t_top.column("l_orderkey"))
    got_q = np.ma.getdata(t_top.column("l_quantity"))
    o2 = np.lexsort((got_q, got_k))
    if t_top.num_rows != keys_want.size or \
            not np.array_equal(got_k[o2], keys_want) or \
            not np.array_equal(got_q[o2], qty_want) or \
            not np.all(np.ma.getdata(t_top.column("r")) == 1) or \
            any(np.ma.getmaskarray(t_top.column(c)).any()
                for c in t_top.column_names):
        raise AssertionError(f"path 2: {t_top.num_rows} rows differ from "
                             f"the oracle's {keys_want.size}")
    err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
        K, torch, "path 2", mm_w2))
    log(f"  path 2 matches numpy exactly: {t_top.num_rows} lines of "
        f"{okeys.size} orders (ties kept)")

    log(f"  the window matrix: {WINDOW_MATRIX_ROWS} rows with nulls, 4 "
        "partitions, on cuda and on the cpu")
    mdata = make_matrix_data(WINDOW_MATRIX_ROWS)

    def window_side(dev):
        sm = srt.session(device=dev)
        t0 = time.perf_counter()
        got = window_matrix(sm.create_dataframe(
            mdata, num_partitions=4), F, Window).collect()
        log(f"    {dev}: {time.perf_counter() - t0:.3f} s, "
            f"{got.num_rows} rows x {len(got.column_names)} columns")
        return got
    window_cuda = window_side("cuda")

    def window_check(window_cpu):
        check_same_tables(window_cuda, window_cpu, "window matrix",
                          summed={"xsum"}, scale=float(mdata["x"].sum()))
        log("  the window matrix agrees on cuda and the cpu: every column "
            f"exact, xsum within rtol {RTOL_F64} + {RTOL_F64} x sum(x)")
    cpu_side("window", lambda: window_side("cpu"), window_check)
    c1_cases(sess, F, Window)
    log("  ROADMAP C1's cases (NaN, +inf and +-2^62 order keys, "
        "rangeBetween(-1, 1)) give Spark's frames on cuda")

    phase("3g", f"TPC-H q1 by its string keys at SF1 ({SF1_LINEITEM} "
        "lineitem rows; the scale rig's generator, seed 23)")
    tpch = make_tpch_tables(SF1_LINEITEM)
    tli = {c: tpch["lineitem"][c] for c in TPCH_Q1_COLUMNS}
    want_q1s = tpch_q1_oracle(tli)
    q1s_runs = {}
    q1s_mb_calls: list = []
    for label, parts, conf in (
            ("q1 by strings, one partition", 1, None),
            ("q1 by strings, 4 partitions, aqe on", 4, None),
            ("q1 by strings, 4 partitions, aqe off", 4,
             {"spark.sql.adaptive.enabled": False})):
        sq = srt.session(conf=conf)
        qs = tpch_q1(sq.create_dataframe(tli, num_partitions=parts), F)
        q_seg: dict = {}
        mb_calls: list = []
        with recording_seg_sums(K, q_seg), \
                recording(H, "murmur3_bytes", mb_calls):
            tq, _, cold_s = drive(label, qs.collect, K, torch,
                                  list(SEG_SUM_BUILDS), by_path)
        for name in SEG_SUM_BUILDS:
            err[name] = max(err[name], check_seg_sum_calls(
                K, torch, name, label, q_seg[name]))
        del q_seg
        check_rows(tq, want_q1s, label)
        ex = exchanges_of(sq.last_plan)
        log("  exchanges: " + ("; ".join(
            f"{e.partitioning.simple_string()} coalesced={e.coalesced} "
            f"rows_partitioned={e.rows_partitioned}" for e in ex) or "none")
            + f"; murmur3_bytes calls {len(mb_calls)}")
        if conf is not None:
            if not mb_calls or any(e.coalesced for e in ex):
                raise AssertionError(f"{label}: the exchanges did not hash "
                                     "and range-partition the string keys")
            q1s_mb_calls = mb_calls
        q1s_runs[label] = dict(query=qs, cold_s=cold_s)
    for row in tq.to_pylist():
        log(f"  {row}")
    log(f"  q1 by strings matches numpy at 1 and 4 partitions (keys and "
        f"counts exact, doubles rtol={RTOL_F64})")
    del tli

    log(f"  the string matrix: {STRING_MATRIX_ROWS} rows, 4 partitions, "
        "sorts, a group-by with min/max, a join and windows over strings, "
        "on cuda and on the cpu")
    sdata = make_string_matrix_data(STRING_MATRIX_ROWS)
    dim_keys = np.unique(sdata["k"])[::2]      # half the keys match
    dim = {"dk": dim_keys, "dv": np.arange(dim_keys.size, dtype=np.int64)}

    def string_side(dev):
        sm = srt.session(device=dev)
        t0 = time.perf_counter()
        got = {name: q.collect() for name, q in string_matrix(
            sm.create_dataframe(sdata, num_partitions=4),
            sm.create_dataframe(dim), F, Window).items()}
        log(f"    {dev}: {time.perf_counter() - t0:.3f} s, "
            + ", ".join(f"{k} {t.num_rows} rows" for k, t in got.items()))
        return got
    string_cuda = string_side("cuda")

    def string_check(string_cpu):
        for name in string_cuda:
            check_same_tables(string_cuda[name], string_cpu[name],
                              f"string matrix {name}")
        if not np.array_equal(
                np.ma.getdata(string_cuda["sort"].column("u")),
                np.ma.getdata(string_cpu["sort"].column("u"))):
            raise AssertionError("string matrix sort: the orders differ")
        log("  the string matrix agrees on cuda and the cpu in every column "
            "(and the sort in its order)")
    cpu_side("strings", lambda: string_side("cpu"), string_check)

    phase("3h", f"the scale rig's ten DataFrame queries, fact table at "
        f"{RIG_ROWS} rows (seed {RIG_SEED}), TPC-H at SF1 ({SF1_LINEITEM} "
        f"lineitem rows, seed {TPCH_SEED}), the rig's scan partitions")
    # phases 3i, 3k and 3m's tables, made in the background meanwhile
    sql_tables = ThreadPoolExecutor(1).submit(make_tpch_tables, SQL_LINEITEM)
    t0 = time.perf_counter()
    from spark_rapids_tpu_torch.sql.physical.join import join_strategies
    rig_t = dict(make_rig_tables(RIG_ROWS), **tpch)
    log(f"  tables generated in {time.perf_counter() - t0:.2f} s")
    rig_runs = {}
    for name, build, check in RIG_QUERIES:
        rig_query = build(sess, rig_t, F, Window)
        q_seg: dict = {}
        q_mm: list = []
        with recording_seg_sums(K, q_seg), \
                recording(K, "murmur3_long", q_mm):
            got, launches, cold_s = drive(f"rig {name}", rig_query.collect,
                                          K, torch, (), by_path)
        check(got, rig_t)
        for kname in SEG_SUM_BUILDS:
            if q_seg[kname]:
                err[kname] = max(err[kname], check_seg_sum_calls(
                    K, torch, kname, f"rig {name}", q_seg[kname]))
        if q_mm:
            err["murmur3_long"] = max(err["murmur3_long"], check_murmur3_calls(
                K, torch, f"rig {name}", q_mm))
        del q_seg, q_mm
        log(f"  rig {name} matches its oracle (the rig's checks in numpy); "
            f"strategies {join_strategies(sess.last_plan)}")
        rig_runs[name] = dict(query=rig_query, cold_s=cold_s,
                              launches=launches)
    rig_launches = {k: sum(r["launches"][k] for r in rig_runs.values())
                    for k in RIG_KERNELS}
    log(f"  the rig's launches of the hand kernels: {rig_launches}")
    for k, n in rig_launches.items():
        if n < 1:
            raise AssertionError(f"no rig query launched {k}")

    log(f"  the scalar matrix: {SCALAR_MATRIX_ROWS} rows, 4 partitions, "
        "every expression of the scalar slice, on cuda and on the cpu")
    xdata = make_scalar_matrix_data(SCALAR_MATRIX_ROWS)

    def scalar_side(dev):
        sx = srt.session(device=dev)
        t0 = time.perf_counter()
        got = {name: q.collect() for name, q in scalar_matrix(
            sx.create_dataframe(xdata, num_partitions=4), F).items()}
        log(f"    {dev}: {time.perf_counter() - t0:.3f} s")
        return got
    scalar_cuda = scalar_side("cuda")

    def scalar_check(scalar_cpu):
        for name, key in (("rows", "u"), ("groups", "k")):
            check_same_tables(scalar_cuda[name], scalar_cpu[name],
                              f"scalar matrix {name}", key=key)
        if scalar_cuda["count"] != scalar_cpu["count"]:
            raise AssertionError("scalar matrix count: cuda "
                                 f"{scalar_cuda['count']}, cpu "
                                 f"{scalar_cpu['count']}")
        log(f"  the scalar matrix agrees on cuda and the cpu: "
            f"{len(scalar_cuda['rows'].column_names)} columns over "
            f"{scalar_cuda['rows'].num_rows} rows, "
            f"{scalar_cuda['groups'].num_rows} groups, count "
            f"{scalar_cuda['count']}")
    cpu_side("scalar", lambda: scalar_side("cpu"), scalar_check)

    phase("3i tables", f"TPC-H at SF 0.5 ({SQL_LINEITEM} lineitem rows, seed "
          f"{TPCH_SEED}) for phases 3i, 3k and 3m, generated beside 3h")
    t0 = time.perf_counter()
    tpch_sql = sql_tables.result()
    log(f"  waited {time.perf_counter() - t0:.2f} s for the tables")
    sql_runs = run_sql_queries(srt, K, torch, tpch_sql, by_path, err)
    t0 = time.perf_counter()
    phase("3j tables", "TPC-DS tables generated")
    tpcds = make_tpcds_tables(TPCDS_ROWS)
    log(f"  TPC-DS tables generated in {time.perf_counter() - t0:.2f} s")
    tpcds_runs = run_tpcds_queries(srt, K, torch, tpcds, by_path, err)
    dec_runs = run_decimal_queries(srt, K, torch, tpch_sql, by_path, err)
    phase("3k matrix", "the decimal matrix")
    decimal_matrix(srt, torch)
    phase("3l trips", "the taxi trips generated")
    started = start_tlc_matrix_cpu(srt)
    t0 = time.perf_counter()
    raw, truth = make_tlc_trips(TLC_ROWS)
    log(f"  TLC trips generated in {time.perf_counter() - t0:.2f} s")
    tlc_runs = run_tlc_queries(srt, K, torch, raw, truth, by_path, err)
    del raw, truth
    tlc_matrix(srt, torch, started)
    pq_runs = parquet_phase(srt, K, torch, decimal_tpch_tables(tpch_sql),
                            rig_t["fact"], by_path, err)
    api = api_phase(srt, K, torch, tpch, rig_t["fact"], pq_runs["root"],
                    by_path, err)
    strings = strings_phase(srt, K, torch, tpch, rig_t["fact"], by_path,
                            err)
    # the matrices' cpu sides ran beside phases 3f-3p; phase 4 times alone
    phase("3 wait", "the background checks")
    finish_cpu_sides()

    # -- phase 4: times ------------------------------------------------------
    phase("4", "times")
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
    wq, tqs = warm_ms(full18, torch)
    log(f"  Q18 SF1: cold {q18_cold_s * 1e3:.3f} ms (first collect, uploads "
        f"included) -> {n_li / q18_cold_s:.0f} lineitem rows/s; warm median "
        f"{wq:.3f} ms of {[round(t, 3) for t in tqs]} ms -> "
        f"{n_li / wq * 1e3:.0f} lineitem rows/s")
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
    mm18 = murmur3_times(K, torch, mm_calls)
    log(f"  (murmur3_long per Q18-inner run: the sum over its "
        f"{len(mm_calls)} launches, {mm18['bytes']} bytes: "
        + ", ".join(f"{k}={v:.5f}" for k, v in mm18.items()
                    if k != "bytes") + ")")
    mm = murmur3_times(K, torch, q18_mm_calls)
    log(f"  (murmur3_long per Q18 run: the sum over its "
        f"{len(q18_mm_calls)} launches, {mm['bytes']} bytes: "
        + ", ".join(f"{k}={v:.5f}" for k, v in mm.items() if k != "bytes")
        + f"; share of bound {mm['bound_ms'] / mm['ms']:.1%}; the "
        f"{mm['big_launches']} launches of at least 2^20 rows: "
        f"{mm['big_ms']:.5f} ms vs bound {mm['big_bound_ms']:.5f} ms, "
        f"{mm['big_bound_ms'] / max(mm['big_ms'], 1e-12):.1%}; phase 4's "
        f"profile gives their time inside the query)")
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
    f64_adds = profile_query("q1", query, torch)["f64_adds"]
    if f64_adds:
        raise AssertionError("q1's profile shows float64 index_add_ kernels: "
                             f"{[k[:80] for k, _, _ in f64_adds]}")
    # the detail profiles (host ops too: a running min or max scan, the byte
    # hash's ranges) where a check or a replay reads them; light ones for
    # the busy share elsewhere
    profile_query("q1, 4 partitions, aqe off", q1_parts["aqe off"], torch,
                  detail=False)
    profile_query("Q18-inner", q18, torch, detail=False)
    # light: Q18's default run hashes no string key (its detail profile
    # found no murmur3_bytes range), and minRows 0's profile below reads them
    profile_query("Q18", full18, torch, detail=False)
    wnn, tnn = warm_ms(nn18, torch)
    log(f"  Q18 without c_name SF1: cold {q18_nn_cold_s * 1e3:.3f} ms; warm "
        f"median {wnn:.3f} ms of {[round(t, 3) for t in tnn]} ms -> "
        f"{n_li / wnn * 1e3:.0f} lineitem rows/s (the same call's Q18 with "
        f"c_name: {wq:.3f} ms)")
    profile_query("Q18 without c_name", nn18, torch, detail=False)
    profile_query("Q18, minRows 0", split18, torch)
    murmur3_bytes_times(H, torch, q18_mb_calls, "Q18, minRows 0")
    for label, run in q1s_runs.items():
        wm, tms = warm_ms(run["query"], torch)
        log(f"  {label}: cold {run['cold_s'] * 1e3:.3f} ms (first collect, "
            f"upload included); warm median {wm:.3f} ms of "
            f"{[round(t, 3) for t in tms]} ms -> "
            f"{SF1_LINEITEM / wm * 1e3:.0f} rows/s")
        if "aqe off" in label:
            profile_query(label, run["query"], torch)
        elif "aqe on" not in label:
            profile_query(label, run["query"], torch, detail=False)
    murmur3_bytes_times(H, torch, q1s_mb_calls, "q1 by strings, aqe off")
    for label, run in w1_runs.items():
        wm, tms = warm_ms(run["query"], torch)
        log(f"  {label}: cold {run['cold_s'] * 1e3:.3f} ms (first collect, "
            f"upload included); warm median {wm:.3f} ms of "
            f"{[round(t, 3) for t in tms]} ms -> {ROWS / wm * 1e3:.0f} "
            "rows/s")
        profile_query(label, run["query"], torch)
    wm2, tms2 = warm_ms(top_q, torch)
    log(f"  path 2: cold {w2_cold_s * 1e3:.3f} ms; warm median {wm2:.3f} ms "
        f"of {[round(t, 3) for t in tms2]} ms -> {n_li / wm2 * 1e3:.0f} "
        "lineitem rows/s")
    profile_query("path 2", top_q, torch)
    w1 = w1_runs["path 1"]
    for label, calls in (("path 1", w1["mm"]), ("path 2", mm_w2)):
        t = murmur3_times(K, torch, calls)
        log(f"  (murmur3_long per {label} run: {len(calls)} launches, "
            f"{t['bytes']} bytes: " + ", ".join(
                f"{k}={v:.5f}" for k, v in t.items() if k != "bytes")
            + f"; share of bound {t['bound_ms'] / t['ms']:.1%})")
    for name in SEG_SUM_BUILDS:
        t = seg_sum_times(K, torch, name, w1["seg"][name])
        log(f"  ({name} per path 1 run: {len(w1['seg'][name])} launches: "
            + ", ".join(f"{k}={v:.5f}" for k, v in t.items()) + ")")
    phase("4 rig", "the scale rig's queries' times")
    log(f"  the scale rig's queries: cold, warm (median of {WARM_RUNS} after "
        f"one warm-up), a profile of one warm run of {PROFILED['rig']}")
    rig_report = []
    for qname, rr in rig_runs.items():
        rr["query"].collect()
        torch.cuda.synchronize()
        wm, tms = warm_ms(rr["query"], torch)
        log(f"  rig {qname}: cold {rr['cold_s'] * 1e3:.3f} ms; warm median "
            f"{wm:.3f} ms of {[round(t, 3) for t in tms]} ms")
        prof = {"wall_ms": None, "busy_ms": None}
        if qname in PROFILED["rig"]:
            # light: the rig line reads the busy share alone
            prof = profile_query(f"rig {qname}", rr["query"], torch,
                                 detail=False)
        rig_report.append({
            "query": qname, "cold_ms": rr["cold_s"] * 1e3, "warm_ms": wm,
            "profiled_wall_ms": prof["wall_ms"],
            "busy_ms": prof["busy_ms"],
            "busy_share": prof["busy_ms"] / prof["wall_ms"]
            if prof["busy_ms"] is not None else None,
            "launches": {k: rr["launches"][k] for k in RIG_KERNELS}})
    log(json.dumps({"rig": rig_report}))
    phase("4 sql", "the float64 TPC-H SQL queries' times")
    sql_report = sql_times(sql_runs, torch)
    phase("4 tpcds", "the TPC-DS queries' times")
    tpcds_times(tpcds_runs, torch)
    phase("4 decimal", "the decimal TPC-H queries' times")
    dec_report = decimal_times(
        dec_runs, {r["query"]: r["warm_ms"] for r in sql_report}, torch)
    phase("4 tlc", "the taxi queries' times")
    tlc_times(tlc_runs, torch)
    phase("4 parquet", "the Parquet queries' times")
    parquet_times(pq_runs["runs"], {r["query"]: r["warm_ms"]
                                    for r in dec_report}, torch)
    phase("4 api", "the API leftovers' times and the pcg64 kernel")
    pcg = api_times(api, K, torch)
    parquet_cleanup(pq_runs["root"])
    phase("4 strings", "phase 3p's times and its four kernels")
    s16 = strings_times(strings, K, torch)
    phase("4 kernels", "murmur3_long back to back")
    b2b = murmur3_back_to_back(K, torch)
    # 8 bytes read and 4 written a row, and 4 read for a per-row seed
    bound_2m = 12 * (1 << 21) / HBM_BYTES_PER_S * 1e3
    log(f"  murmur3_long back to back, n=2^21, 256 launches over 8 inputs "
        f"(128 MB), events around the run: scalar seed "
        f"{b2b['scalar']:.5f} ms a launch (bound {bound_2m:.5f} ms, "
        f"{bound_2m / b2b['scalar']:.1%}); per-row seed "
        f"{b2b['per-row']:.5f} ms (bound "
        f"{bound_2m * 16 / 12:.5f} ms, "
        f"{bound_2m * 16 / 12 / b2b['per-row']:.1%})")
    replaces = {
        "seg_sum_f32": "spark_rapids_tpu/ops/pallas_kernels.py:126",
        # no Pallas kernel: the XLA scatter seg_sum2 of the double sums
        "seg_sum_f64": "spark_rapids_tpu/ops/segmented.py:68"}
    def per_path(name):
        return {label: got[name] for label, got in by_path.items()
                if got[name]}
    kernels = [{
        "name": name, "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/seg_sum.cu",
        "replaces": replaces[name],
        "launches": q1_launches[name],
        "launches_by_path": per_path(name),
        "max_abs_err": err[name],
        "ms": seg[name]["ms"], "plain_ms": seg[name]["plain_ms"],
        "bound_ms": seg[name]["bound_ms"], "bound_by": "bytes",
        "library_ms": seg[name]["library_ms"],
    } for name in SEG_SUM_BUILDS] + [{
        "name": "murmur3_long", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
        "replaces": "spark_rapids_tpu/ops/pallas_kernels.py:64",
        "launches": q18_full_launches["murmur3_long"],
        "launches_by_path": per_path("murmur3_long"),
        "max_abs_err": err["murmur3_long"],
        "ms": mm["ms"], "plain_ms": mm["plain_ms"],
        "bound_ms": mm["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "bytes": mm["bytes"],
        "b2b_ms": b2b["scalar"],
    }, {
        # no TPU kernel: the JAX package draws rand() on the host
        "name": "pcg64", "route": "cuda",
        "source": "spark_rapids_tpu_torch/csrc/pcg64.cu",
        "replaces": "spark_rapids_tpu/sql/expressions/context_fns.py:160",
        "launches": api["runs"]["rand_ids"]["launches"]["pcg64"],
        "launches_by_path": per_path("pcg64"),
        "max_abs_err": err["pcg64"],
        "ms": pcg["ms"], "plain_ms": pcg["plain_ms"],
        "bound_ms": pcg["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "b2b_ms": pcg["b2b_ms"],
    }] + [{
        # no TPU kernel: the JAX package runs md5, the double's text and the
        # regexp DFA on its host or as a lax.scan
        "name": name, "route": "cuda",
        "source": f"spark_rapids_tpu_torch/csrc/{STRING_TAIL_SOURCES[name]}.cu",
        "replaces": STRING_TAIL_REPLACES[name],
        "launches": strings["launches"][name],
        "launches_by_path": per_path(name),
        "max_abs_err": err[name],
        "ms": s16[name]["ms"], "plain_ms": s16[name]["plain_ms"],
        "bound_ms": s16[name]["bound_ms"],
        "bound_by": s16[name]["bound_by"], "library_ms": None,
    } for name in STRING_TAIL_KERNELS]
    log(json.dumps(phase_seconds()))
    log(json.dumps({"kernels": kernels}))
    log(card)
    # the run used one card, device 0
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
