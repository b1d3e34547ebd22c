"""Time the string tail's hand kernels against earlier versions of their
sources and against variants of them, in one process on one CUDA card.  Two
modes:

    python3 tools/strings_ab.py [--parent-regex OLD_REGEX_DFA_CU]
                                [--parent-dtoa OLD_DTOA_CU] [--build-dir DIR]
                                [--rows LINEITEM_ROWS]
    python3 tools/strings_ab.py --mode md5_search
                                [--parent-md5 OLD_MD5_CU]
                                [--parent-regex OLD_REGEX_DFA_CU]
                                [--build-dir DIR] [--rows LINEITEM_ROWS]

The first (``--mode spans_dtoa``, the default) times the span kernel
``dfa_match_spans`` (``spark_rapids_tpu_torch/csrc/regex_dfa.cu``) and the
shortest-digits kernel ``dtoa_shortest`` (``csrc/dtoa.cu``), over the span
kernel's two kernels and tile sizes; the second times ``md5``
(``csrc/md5.cu``) and the search kernel ``dfa_search`` (``regex_dfa.cu``)
(see :func:`md5_search_main`).

The parents are earlier sources with the same C interface, for instance
written out of git with ``git show <commit>:spark_rapids_tpu_torch/csrc/
regex_dfa.cu``.  Every build goes into ``--build-dir`` (default
``build/strings_ab``, which git ignores), one nvcc per build, all started
together; a swept variant is a copy of the current source written there with
one constant edited (``SPAN_BUILDS``, ``DTOA_BUILDS``).  The inputs are the calls that ``chip_smoke.py`` phase 3p's items
make, recorded from the same SQL over the same generated tables
(``--rows`` lineitem rows, SF1 by default, 4 partitions): regexp_replace
over l_comment (``make_l_comment``; 8 span calls), regexp_extract of c_phone
(4 span calls) and CAST(l_extendedprice AS STRING) (12 dtoa calls).  Every
timing sums an item's calls, each launch after the L2 flush that reads
(``chip_smoke.cuda_ms``), and includes the wrapper: allocation (the
parent's span outputs zero-filled, as its wrapper did) and the launch.

It prints, one JSON line each, after the card's name and power limit:
- ``split``: the parent span kernel's time cut into its wrapper's zero fill
  (two ``torch.zeros``) and its bare launch into outputs allocated once,
  and the same bare launch back to back with no flush; the current
  kernel's bare launch; ``zero_`` of both outputs, the write floor; and,
  grid for grid with the current tile kernel (its blocks, threads and
  shared memory), a launch of an empty kernel and of one that only reads
  the first tile's lengths and loads the DFA's tables into shared memory
  (``PROBE_SOURCE``): the fixed cost of a launch; and the host's
  microseconds a bare launch of each build (200 calls enqueued, their
  wall time before the sync over 200: the C function's queries and the
  launch, not the card's time), and the same for dtoa's wrapper;
- ``sweep``: for each build of the current span source (the tile kernel
  at 32 to 512 rows a block, ``kTileRows``; the warp kernel at every
  width, ``kTileMaxWidth`` -1), ptxas's registers and spill bytes and its
  ms on both items, twice (the builds in one order, then the other), after
  a check of its outputs against the plain version;
- ``dtoa_sweep``: the same for builds of the current dtoa source by its
  grid (``kBlocksPerSm``: 6, 16, or enough for a block every 256 rows), on
  the 12 dtoa calls;
- ``ab``: the parent and current builds in turns (parent, current,
  current, parent) on the three items, with the bounds ``chip_smoke.py``
  gives them (``string_tail_work``) and each share;
- ``sass``: per build of ``dtoa.cu`` (parent and current), the SASS
  instructions (``nvdisasm`` of a ``-lineinfo`` cubin, the same code as the
  library) by source region: the three ``rop`` products, ``choose``,
  ``finish`` with its strip of trailing zeros, the rest; the parent's loop
  (the lines of its ``while``) at each of its inlined call sites, and its
  mean trips a row over the item's values.  ``sass_counts`` reads a saved
  disassembly (``build/strings_ab/dtoa_<label>.sass``) the same way."""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from spark_rapids_tpu_torch.ops import kernels as K  # noqa: E402

#: the span builds swept: label -> (line of the source, its replacement)
SPAN_BUILDS = {f"tile{r}": (("constexpr int kTileRows = 256;",
                             f"constexpr int kTileRows = {r};"),)
               for r in (32, 64, 128, 256, 512)}
SPAN_BUILDS["warp"] = (("constexpr int kTileMaxWidth = 254;",
                        "constexpr int kTileMaxWidth = -1;"),)
#: the dtoa builds swept by blocks an SM (2^20: a block for every 256 rows)
DTOA_BUILDS = {f"blocks{b}": (("constexpr int kBlocksPerSm = 16;",
                               f"constexpr int kBlocksPerSm = {b};"),)
               for b in (6, 16, 1 << 20)}
VP, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

#: two kernels launched grid for grid with the current tile kernel: one
#: that does nothing, and one that reads the first tile's lengths and loads
#: the DFA's tables as the tile kernel does before its first walk.  It
#: includes the source, so it takes the same constants and grid.
PROBE_SOURCE = r"""
#include "{source}"

namespace {{

__global__ void __launch_bounds__(kTileRows) launch_only_kernel(uint8_t* sink, long long rows) {{
  if (rows < 0) sink[0] = 1;  // never
}}

__global__ void __launch_bounds__(kTileRows)
tables_only_kernel(const int32_t* __restrict__ lens, const uint8_t* __restrict__ table,
                   const uint8_t* __restrict__ cls, const uint8_t* __restrict__ accept,
                   int states, int classes, uint8_t* __restrict__ sink, long long rows) {{
  extern __shared__ __align__(16) uint8_t spans_smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long r0 = (static_cast<long long>(blockIdx.x) * (kTileRows / 32) + warp) * 32;
  const int len = r0 + lane < rows ? lens[r0 + lane] : 0;
  const Dfa d = load(spans_smem, table, cls, accept, states, classes);
  // never (a length is not negative): keeps the loads
  if (len < 0 && d.accept[lane] + d.table[lane % (states * classes)] == 0) sink[0] = 1;
}}

}}  // namespace

extern "C" int dfa_spans_probe(int tables, long long width, const void* lens,
                               const void* table, const void* cls, const void* accept,
                               int states, int classes, void* sink, long long rows,
                               void* stream) {{
  const int smem = tile_smem_bytes(states, classes, static_cast<int>(width));
  int grid = 0;
  cudaError_t e = spans_grid(smem, grid);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(launch_only_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tables_only_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (rows + kTileRows - 1) / kTileRows;
  if (blocks > grid) blocks = grid;
  const auto s = static_cast<cudaStream_t>(stream);
  if (tables)
    tables_only_kernel<<<static_cast<int>(blocks), kTileRows, smem, s>>>(
        static_cast<const int32_t*>(lens), static_cast<const uint8_t*>(table),
        static_cast<const uint8_t*>(cls), static_cast<const uint8_t*>(accept), states, classes,
        static_cast<uint8_t*>(sink), rows);
  else
    launch_only_kernel<<<static_cast<int>(blocks), kTileRows, smem, s>>>(
        static_cast<uint8_t*>(sink), rows);
  return static_cast<int>(cudaGetLastError());
}}
"""


def arg(argv, flag, default=None):
    return argv[argv.index(flag) + 1] if flag in argv else default


def edited(src: Path, edits, out: Path) -> Path:
    """A copy of ``src`` at ``out`` with each (line, replacement) of
    ``edits`` made; each line must be in the source once."""
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{src.name}: {old!r} is not in it once")
        text = text.replace(old, new)
    out.write_text(text)
    return out


def nvcc(src: Path, out: Path) -> tuple:
    """Build ``src`` into ``out`` with the port's flags; (path, ptxas)."""
    cmd = [K._nvcc(), *K.NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{proc.stderr}")
    return out, proc.stdout + proc.stderr


def spans_fn(lib, zero_fill: bool):
    """fn(dfa, chars, lens) -> (chosen, mlen) through ``lib``, as the
    wrapper does: outputs allocated (zeroed for a parent), then the
    launch."""
    lib.dfa_match_spans.argtypes = [VP, LL, VP, VP, VP, VP, I, I, I, I, I, I,
                                    VP, VP, LL, VP]
    lib.dfa_match_spans.restype = I
    alloc = torch.zeros if zero_fill else torch.empty

    def fn(dfa, chars, lens, outs=None):
        rows, width = chars.shape
        if outs is None:
            outs = (alloc(rows, width + 1, dtype=torch.bool, device="cuda"),
                    alloc(rows, width + 1, dtype=torch.int32, device="cuda"))
        err = lib.dfa_match_spans(
            chars.data_ptr(), width, lens.data_ptr(), dfa["table"].data_ptr(),
            dfa["cls"].data_ptr(), dfa["accept"].data_ptr(), dfa["states"],
            dfa["classes"], dfa["start"], dfa["dead"],
            int(dfa["anchored_start"]), int(dfa["anchored_end"]),
            outs[0].data_ptr(), outs[1].data_ptr(), rows,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dfa_match_spans launch failed: {err}")
        return outs
    return fn


def probe_launch(lib):
    """fn(tables, dfa, chars, lens): one launch of ``PROBE_SOURCE``'s empty
    kernel (tables 0) or its tables-only kernel (1), grid for grid with the
    current tile kernel on the same call."""
    lib.dfa_spans_probe.argtypes = [I, LL, VP, VP, VP, VP, I, I, VP, LL, VP]
    lib.dfa_spans_probe.restype = I
    sink = torch.zeros(16, dtype=torch.uint8, device="cuda")

    def fn(tables, dfa, chars, lens):
        err = lib.dfa_spans_probe(
            tables, chars.shape[1], lens.data_ptr(), dfa["table"].data_ptr(),
            dfa["cls"].data_ptr(), dfa["accept"].data_ptr(), dfa["states"],
            dfa["classes"], sink.data_ptr(), chars.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dfa_spans_probe launch failed: {err}")
    return fn


def dtoa_fn(lib):
    """fn(values) -> (digits, exps, sides) through ``lib``, as the wrapper
    does."""
    lib.dtoa_shortest.argtypes = [VP, I, LL, VP, VP, VP, I, I, I, VP, VP, VP,
                                  VP]
    lib.dtoa_shortest.restype = I

    def fn(values):
        n = values.shape[0]
        outs = (torch.empty(n, dtype=torch.int64, device="cuda"),
                torch.empty(n, dtype=torch.int32, device="cuda"),
                torch.empty(n, dtype=torch.int8, device="cuda"))
        is_float = values.dtype == torch.float32
        t = K.dtoa_tables(is_float)
        kq, f2, g = K._dtoa_device_tables(is_float, values.device)
        err = lib.dtoa_shortest(
            values.data_ptr(), int(is_float), n, kq.data_ptr(),
            f2.data_ptr(), g.data_ptr(), t["nq"], t["k_min"], t["c_tiny"],
            *[o.data_ptr() for o in outs],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dtoa_shortest launch failed: {err}")
        return outs
    return fn


def record_calls(rows: int) -> dict:
    """The span and dtoa calls of phase 3p's regexp_replace,
    regexp_extract and cast_double items (their SQL, over the same
    generated tables at ``rows`` lineitem rows), with each item's live
    lengths or values for the bounds."""
    import spark_rapids_tpu_torch as srt
    tpch = cs.make_tpch_tables(rows)
    li, cu = tpch["lineitem"], tpch["customer"]
    l_comment, comments, cidx = cs.make_l_comment(rows)
    sess = srt.session()
    sess.create_dataframe(
        {"l_returnflag": li["l_returnflag"],
         "l_extendedprice": li["l_extendedprice"], "l_comment": l_comment},
        num_partitions=cs.STRING_PARTITIONS).createOrReplaceTempView(
            "lineitem")
    sess.create_dataframe({"c_phone": cu["c_phone"]},
                          num_partitions=cs.STRING_PARTITIONS
                          ).createOrReplaceTempView("customer")
    items = {
        "l_comment": ("dfa_match_spans", "SELECT l_returnflag f, sum(length("
                      "regexp_replace(l_comment, '[aeiou]+', '#'))) n, max("
                      "regexp_replace(l_comment, '[aeiou]+', '#')) m FROM "
                      "lineitem GROUP BY l_returnflag ORDER BY f"),
        "c_phone": ("dfa_match_spans", "SELECT regexp_extract(c_phone, "
                    "'^[0-9]+', 0) cc, count(*) n FROM customer GROUP BY cc "
                    "ORDER BY cc"),
        "dtoa": ("dtoa_shortest", "SELECT l_returnflag f, sum(length(CAST("
                 "l_extendedprice AS STRING))) n, sum(CASE WHEN CAST("
                 "l_extendedprice AS STRING) LIKE '%.5' THEN 1 ELSE 0 END) h,"
                 " sum(CAST(replace(CAST(l_extendedprice AS STRING), '.', '')"
                 " AS BIGINT)) d FROM lineitem GROUP BY l_returnflag ORDER BY"
                 " f")}
    on_card = {"dfa_match_spans": lambda a: a[1].is_cuda,
               "dtoa_shortest": lambda a: a[0].is_cuda}
    out = {}
    for label, (name, sql) in items.items():
        calls: list = []
        with cs.recording(K, name, calls, on_card[name]):
            sess.sql(sql).collect()
        torch.cuda.synchronize()
        if label == "l_comment":
            live = dict(lens=np.array([len(c.encode())
                                       for c in comments])[cidx])
        elif label == "c_phone":
            live = dict(lens=np.array([len(p.encode())
                                       for p in cu["c_phone"]]))
        else:
            live = dict(values=rows)
        nbytes, ops = cs.string_tail_work(name, calls, **live)
        bound = max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.INT_OPS_PER_S) * 1e3
        out[label] = dict(name=name, calls=calls, bound_ms=bound,
                          bound_by="operations" if ops / cs.INT_OPS_PER_S >
                          nbytes / cs.HBM_BYTES_PER_S else "bytes")
    return out


def host_us(fn, calls, n: int = 200) -> float:
    """The host's microseconds a call of ``fn`` over ``calls`` in turn, as
    enqueued: ``n`` calls' wall time before the sync, over ``n``."""
    import time
    for args in calls:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*calls[i % len(calls)])
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def item_ms(fn, calls) -> float:
    """An item's calls through ``fn``, summed, each after the flush."""
    return sum(cs.cuda_ms(lambda: fn(*args), flush_l2=True) for args in calls)


def check_spans(fn, calls, want, label):
    for args, (wc, wm) in zip(calls, want):
        c, m = fn(*args)
        torch.cuda.synchronize()
        if not (torch.equal(c, wc) and torch.equal(m, wm)):
            raise AssertionError(f"{label}: spans != plain")


def check_dtoa(fn, calls, label):
    for (values,) in calls:
        got, want = fn(values), K.dtoa_plain(values)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label}: dtoa != plain")


def function_lines(src: str, name: str) -> range:
    """The lines (1-based) of the definition of ``name`` in ``src``."""
    lines = src.splitlines()
    for i, line in enumerate(lines):
        if re.search(rf"\b{name}\(", line) and "__device__" in " ".join(
                lines[max(0, i - 1):i + 1]):
            depth, seen = 0, False
            for j in range(i, len(lines)):
                depth += lines[j].count("{") - lines[j].count("}")
                seen = seen or "{" in lines[j]
                if seen and depth == 0:
                    return range(i + 1, j + 2)
    return range(0)


def sass_regions(src_path: Path, build_dir: Path, label: str) -> dict:
    """SASS instructions of both dtoa kernels by source region, from
    ``nvdisasm`` of a ``-lineinfo`` cubin of ``src_path`` (line info does
    not change the code)."""
    cubin = build_dir / f"dtoa_{label}.cubin"
    flags = [f for f in K.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                  "-fPIC")]
    proc = subprocess.run([K._nvcc(), *flags, "-cubin", "-lineinfo", "-o",
                           str(cubin), str(src_path)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed: {proc.stderr}")
    nvdisasm = str(Path(K._nvcc()).parent / "nvdisasm")
    for flags in (["-gi", "-c"], ["-g", "-c"], ["-g"]):
        dis = subprocess.run([nvdisasm, *flags, str(cubin)],
                             capture_output=True, text=True)
        if dis.returncode == 0 and "//##" in dis.stdout:
            break
    if dis.returncode != 0:
        raise RuntimeError(f"nvdisasm failed: {dis.stderr}")
    cubin.with_suffix(".sass").write_text(dis.stdout)
    return sass_counts(dis.stdout, src_path.read_text())


def sass_counts(sass: str, src: str) -> dict:
    """Instructions of each dtoa kernel in ``sass`` (nvdisasm with line
    info) by the region of ``src`` its innermost source line is in."""
    regions = {"rop": [*function_lines(src, "rop_d"),
                       *function_lines(src, "rop_f")],
               "choose": list(function_lines(src, "choose")),
               "finish and strip": [
                   line for name in ("finish", "strip", "strip_step",
                                     "strip_step32")
                   for line in function_lines(src, name)]}
    loop = [i + 1 for i, line in enumerate(src.splitlines())
            if "while (d != 0 && d % 10 == 0)" in line]
    loop_lines = set(range(loop[0], loop[0] + 4)) if loop else set()
    out: dict = {}
    kernel, line, chain, pending = None, None, (), []
    for text in sass.splitlines():
        m = re.match(r"\s*\.text\.(\S+):", text)
        if m:
            kernel = "f32" if "f32" in m.group(1) else (
                "f64" if "f64" in m.group(1) else None)
            continue
        m = re.search(r'//## File ".*?", line (\d+)(.*)', text)
        if m:
            pending.append((int(m.group(1)),
                            tuple(re.findall(r"line (\d+)", m.group(2)))))
            continue
        if kernel is None or not re.match(r"\s*/\*[0-9a-f]{4}\*/\s+\S", text):
            continue
        if pending:
            # an inlined line is printed before its call site's: the first
            # with a chain is the innermost
            line, chain = next((p for p in pending if p[1]), pending[-1])
            pending = []
        k = out.setdefault(kernel, {"total": 0, "rest": 0, "loop_body": 0,
                                    "loop_by_site": {},
                                    **{r: 0 for r in regions}})
        k["total"] += 1
        region = next((r for r, ls in regions.items() if line in ls), "rest")
        k[region] += 1
        if line in loop_lines:
            k["loop_body"] += 1
            site = f"inlined at line {chain[-1]}" if chain else "not inlined"
            k["loop_by_site"][site] = k["loop_by_site"].get(site, 0) + 1
    return out


def strip_trips(values) -> float:
    """The parent's trailing-zero loop trips a row (mean) over the
    nonzero digits of ``values`` (a partition's live rows; its padding is
    0.0): the zeros of the digits before the strip."""
    seen = []
    strip = K.strip_zeros_plain

    def record(d, e):
        seen.append(d.clone())
        return strip(d, e)
    K.strip_zeros_plain = record
    try:
        K.dtoa_plain(values)
    finally:
        K.strip_zeros_plain = strip
    d = seen[0][seen[0] != 0]
    trips = torch.zeros_like(d)
    for _ in range(19):
        z = (d != 0) & (d % 10 == 0)
        trips += z.long()
        d = torch.where(z, d // 10, d)
    return float(trips.double().mean())


def spans_dtoa_main(argv) -> int:
    parent_regex = arg(argv, "--parent-regex")
    parent_dtoa = arg(argv, "--parent-dtoa")
    build_dir = Path(arg(argv, "--build-dir",
                         ROOT / "build" / "strings_ab"))
    rows = int(arg(argv, "--rows", cs.SF1_LINEITEM))
    build_dir.mkdir(parents=True, exist_ok=True)
    card = cs.nvidia_smi_card()
    print(card, flush=True)
    regex_src, dtoa_src = K.CSRC / "regex_dfa.cu", K.CSRC / "dtoa.cu"
    jobs = {k: (edited(regex_src, e, build_dir / f"regex_dfa_{k}.cu"),
                build_dir / f"libregex_dfa_{k}.so")
            for k, e in SPAN_BUILDS.items()}
    jobs.update({k: (edited(dtoa_src, e, build_dir / f"dtoa_{k}.cu"),
                     build_dir / f"libdtoa_{k}.so")
                 for k, e in DTOA_BUILDS.items()})
    jobs["regex current"] = (regex_src, build_dir / "libregex_dfa.so")
    jobs["dtoa current"] = (dtoa_src, build_dir / "libdtoa.so")
    probe = build_dir / "spans_probe.cu"
    probe.write_text(PROBE_SOURCE.format(source=regex_src.resolve()))
    jobs["probe"] = (probe, build_dir / "libspans_probe.so")
    if parent_regex:
        jobs["regex parent"] = (Path(parent_regex),
                                build_dir / "libregex_dfa_parent.so")
    if parent_dtoa:
        jobs["dtoa parent"] = (Path(parent_dtoa),
                               build_dir / "libdtoa_parent.so")
    sass_jobs = {"current": dtoa_src}
    if parent_dtoa:
        sass_jobs["parent"] = Path(parent_dtoa)
    with ThreadPoolExecutor(len(jobs) + len(sass_jobs)) as pool:
        built = {k: pool.submit(nvcc, *v) for k, v in jobs.items()}
        sass = {k: pool.submit(sass_regions, p, build_dir, k)
                for k, p in sass_jobs.items()}
        built = {k: f.result() for k, f in built.items()}
        sass = {k: f.result() for k, f in sass.items()}

    items = record_calls(rows)
    spans_items = ("l_comment", "c_phone")
    want = {k: [K.dfa_match_spans_plain(*args) for args in items[k]["calls"]]
            for k in spans_items}
    lib = {k: ctypes.CDLL(str(v[0])) for k, v in built.items()}
    spans = {"current": spans_fn(lib["regex current"], False)}
    dtoa = {"current": dtoa_fn(lib["dtoa current"])}
    if parent_regex:
        spans["parent"] = spans_fn(lib["regex parent"], True)
    if parent_dtoa:
        dtoa["parent"] = dtoa_fn(lib["dtoa parent"])
    for k, fn in spans.items():
        for item in spans_items:
            check_spans(fn, items[item]["calls"], want[item], f"{k} {item}")
    for k, fn in dtoa.items():
        check_dtoa(fn, items["dtoa"]["calls"], k)
    probe_fn = probe_launch(lib["probe"])

    # the split: the parent's fill and bare launch, the current bare launch
    split = {}
    for item in spans_items:
        calls = items[item]["calls"]
        outs = [(torch.zeros(a[1].shape[0], a[1].shape[1] + 1,
                             dtype=torch.bool, device="cuda"),
                 torch.zeros(a[1].shape[0], a[1].shape[1] + 1,
                             dtype=torch.int32, device="cuda"))
                for a in calls]
        row = {"write_floor_ms": sum(
            cs.cuda_ms(lambda: (o[0].zero_(), o[1].zero_()), flush_l2=True)
            for o in outs)}
        if parent_regex:
            p = spans["parent"]
            row["parent_fill_ms"] = sum(cs.cuda_ms(lambda: (
                torch.zeros(a[1].shape[0], a[1].shape[1] + 1,
                            dtype=torch.bool, device="cuda"),
                torch.zeros(a[1].shape[0], a[1].shape[1] + 1,
                            dtype=torch.int32, device="cuda")),
                flush_l2=True) for a in calls)
            row["parent_bare_ms"] = sum(cs.cuda_ms(
                lambda: p(*a, outs=o), flush_l2=True)
                for a, o in zip(calls, outs))
            row["parent_bare_b2b_ms"] = sum(cs.cuda_ms(
                lambda: p(*a, outs=o)) for a, o in zip(calls, outs))
            row["parent_bare_host_us"] = host_us(
                lambda a, o: p(*a, outs=o), list(zip(calls, outs)))
        c = spans["current"]
        row["current_bare_ms"] = sum(cs.cuda_ms(
            lambda: c(*a, outs=o), flush_l2=True) for a, o in zip(calls, outs))
        row["current_bare_host_us"] = host_us(
            lambda a, o: c(*a, outs=o), list(zip(calls, outs)))
        for key, tables in (("launch_only_ms", 0), ("tables_only_ms", 1)):
            row[key] = sum(cs.cuda_ms(lambda: probe_fn(tables, *a),
                                      flush_l2=True) for a in calls)
        row["tile_path"] = [K.dfa_spans_path(a[0], a[1].shape[1]) == 0
                            for a in calls]
        split[item] = row
        del outs
    split["dtoa_host_us"] = {k: host_us(fn, items["dtoa"]["calls"])
                             for k, fn in dtoa.items()}
    print(json.dumps({"split": split, "card": card}), flush=True)

    sweep = {}
    for k, edits in SPAN_BUILDS.items():
        fn = spans_fn(lib[k], False)
        for item in spans_items:
            check_spans(fn, items[item]["calls"], want[item], f"{k} {item}")
        sweep[k] = {"edits": [new for _, new in edits], "ptxas": [
            {"kernel": f, "registers": r, "spill_bytes": s + lo}
            for f, r, s, lo in cs.spill_report(built[k][1])
            if "spans" in f], "fn": fn,
            **{f"{item}_ms": [] for item in spans_items}}
    for k in list(SPAN_BUILDS) + list(SPAN_BUILDS)[::-1]:
        for item in spans_items:
            sweep[k][f"{item}_ms"].append(
                item_ms(sweep[k]["fn"], items[item]["calls"]))
    for v in sweep.values():
        del v["fn"]
    print(json.dumps({"sweep": sweep, "card": card}), flush=True)

    dsweep = {}
    for k, edits in DTOA_BUILDS.items():
        fn = dtoa_fn(lib[k])
        check_dtoa(fn, items["dtoa"]["calls"], k)
        dsweep[k] = {"edits": [new for _, new in edits], "ptxas": [
            {"kernel": f, "registers": r, "spill_bytes": s + lo}
            for f, r, s, lo in cs.spill_report(built[k][1])], "fn": fn,
            "dtoa_ms": []}
    for k in list(DTOA_BUILDS) + list(DTOA_BUILDS)[::-1]:
        dsweep[k]["dtoa_ms"].append(item_ms(dsweep[k]["fn"],
                                            items["dtoa"]["calls"]))
    for v in dsweep.values():
        del v["fn"]
    print(json.dumps({"dtoa_sweep": dsweep, "card": card}), flush=True)

    order = ["parent", "current", "current", "parent"] if parent_regex \
        else ["current", "current"]
    ab = {k: [] for k in order}
    for label in order:
        got = {item: item_ms(spans[label], items[item]["calls"])
               for item in spans_items if label in spans}
        if label in dtoa:
            got["dtoa"] = item_ms(dtoa[label], items["dtoa"]["calls"])
        ab[label].append(got)
    bounds = {k: {"bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                  "launches": len(v["calls"])} for k, v in items.items()}
    for k, runs in ab.items():
        for item in bounds:
            ms = [r[item] for r in runs if item in r]
            if ms:
                bounds[item][f"{k}_share"] = [bounds[item]["bound_ms"] / t
                                              for t in ms]
    print(json.dumps({"ab": ab, "bounds": bounds, "card": card}), flush=True)

    trips = strip_trips(items["dtoa"]["calls"][0][0])
    print(json.dumps({"sass": sass, "parent_loop_trips_a_row": trips,
                      "dtoa_ops_bound": cs.DTOA_OPS, "card": card}),
          flush=True)
    return 0



# --------------------------------------------------------------------------
# --mode md5_search: md5 and the search kernel dfa_search
# --------------------------------------------------------------------------

#: md5 builds swept by threads a block (each a copy of the source with one
#: constant edited); the staged variant (B) is ``MD5_PROBE_SOURCE``'s
MD5_BUILDS = {f"threads{t}": (("constexpr int kThreads = 256;",
                               f"constexpr int kThreads = {t};"),)
              for t in (128, 512)}
#: dfa_search builds swept the same way
SEARCH_BUILDS = {f"threads{t}": (("constexpr int kSearchThreads = 512;",
                                  f"constexpr int kSearchThreads = {t};"),)
                 for t in (128, 256)}
#: the rows of the sweeps' synthetic batches (check_md5's widths 128 and
#: 130, check_dfa's 16, 64 and 200)
SWEEP_ROWS = 1 << 19

#: Beside the current md5 source (it includes it, so it takes the same
#: constants and helpers): an empty kernel launched on the parent's grid
#: (at most 132 x 16 blocks) or the current one, and variant (B) of the
#: row loads, a warp's 32 rows staged in shared memory.
MD5_PROBE_SOURCE = r"""
#include "{source}"

#include <map>
#include <mutex>

namespace {{

__global__ void __launch_bounds__(kThreads) md5_empty_kernel(uint8_t* sink, long long rows) {{
  if (rows < 0) sink[0] = 1;  // never
}}

// the row stride of the staged bytes: a multiple of 4 bytes and an odd count of words
__host__ __device__ __forceinline__ int staged_stride(int width) {{
  const int w = (width + 3) & ~3;
  return (w / 4) % 2 ? w : w + 4;
}}

// (B): each warp copies its 32 rows' bytes into shared memory with coalesced 16-byte loads
// (none wholly past a row's length or of a row that is not valid), then each lane hashes
// its own row from there.  Rows whose width is not a multiple of 16, or not 16-byte
// aligned, take the thread path.
__global__ void __launch_bounds__(kThreads)
md5_staged_kernel(const uint8_t* __restrict__ chars, int width, const int32_t* __restrict__ lens,
                  const bool* __restrict__ valid, uint8_t* __restrict__ out, long long rows) {{
  extern __shared__ __align__(16) uint8_t staged[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int stride = staged_stride(width);
  uint8_t* s_rows = staged + warp * 32 * stride;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * (kThreads / 32) + warp) * 32;
       r0 < rows; r0 += step) {{
    const int nr = rows - r0 < 32 ? static_cast<int>(rows - r0) : 32;
    const long long r = r0 + lane;
    const bool ok = lane < nr && (valid == nullptr || valid[r]);
    const int len = ok ? clamp_len(lens[r], width) : 0;
    const uint8_t* src = chars + r0 * width;
    const int chunks = nr * width / 16;
    for (int i0 = 0; i0 < chunks; i0 += 32) {{
      const int i = i0 + lane;
      const int row = 16 * i / width, col = 16 * i - row * width;
      const int row_len = __shfl_sync(0xffffffffu, len, row & 31);
      if (i >= chunks || col >= row_len) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * static_cast<long long>(i));
      uint32_t* d = reinterpret_cast<uint32_t*>(s_rows + row * stride + col);
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }}
    __syncwarp();
    if (lane < nr) {{
      uint8_t* o = out + r * 32;
      if (!ok) {{
        reinterpret_cast<uint4*>(o)[0] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(o)[1] = make_uint4(0, 0, 0, 0);
      }} else {{
        const uint32_t* w = reinterpret_cast<const uint32_t*>(s_rows + lane * stride);
        uint32_t st[4] = {{0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u}};
        const int last = (len + 8) / 64;
        for (int b = 0; b <= last; ++b) {{
          uint32_t m[16];
#pragma unroll
          for (int k = 0; k < 16; ++k) {{
            const int at = b * 64 + 4 * k;
            m[k] = end_word(at < len ? w[at / 4] : 0u, len - at);
          }}
          if (b == last) {{
            m[14] = static_cast<uint32_t>(len) << 3;
            m[15] = static_cast<uint32_t>(len) >> 29;
          }}
          md5_block(st, m);
        }}
        store_hex(o, st);
      }}
    }}
    __syncwarp();
  }}
}}

// the kernel's loads and stores alone: each row's validity and length, the 16-byte chunks
// that start before its end read and folded by XOR, and its 32 bytes written (zeros for a
// row that is not valid), no hash
__global__ void __launch_bounds__(kThreads)
md5_loads_kernel(const uint8_t* __restrict__ chars, long long width,
                 const int32_t* __restrict__ lens, const bool* __restrict__ valid,
                 uint8_t* __restrict__ out, long long rows) {{
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; r < rows;
       r += stride) {{
    uint8_t* o = out + r * 32;
    if (valid != nullptr && !valid[r]) {{
      reinterpret_cast<uint4*>(o)[0] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(o)[1] = make_uint4(0, 0, 0, 0);
      continue;
    }}
    const int len = clamp_len(lens[r], width);
    uint32_t x[4] = {{0, 0, 0, 0}};
    for (int at = 0; at < len; at += 16) {{
      const uint4 v = *reinterpret_cast<const uint4*>(chars + r * width + at);
      x[0] ^= v.x;
      x[1] ^= v.y;
      x[2] ^= v.z;
      x[3] ^= v.w;
    }}
    store_hex(o, x);
  }}
}}

std::mutex probe_mutex;
std::map<int, int> staged_grids;  // shared memory -> blocks

}}  // namespace

// kind 0: the empty kernel on the parent's grid; 1: on the current grid; 2: variant (B),
// on as many blocks as the SMs hold at once (the thread path where it does not apply); 3:
// the loads and stores alone, on the current grid
extern "C" int md5_probe(int kind, const void* chars, long long width, const void* lens,
                         const void* valid, void* out, long long rows, void* stream) {{
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sink = static_cast<uint8_t*>(out);
  long long blocks = (rows + kThreads - 1) / kThreads;
  if (kind <= 1 || kind == 3) {{
    int grid = 132 * 16;
    if (kind != 0) {{
      const cudaError_t e = md5_grid(grid);
      if (e != cudaSuccess) return static_cast<int>(e);
    }}
    if (blocks > grid) blocks = grid;
    if (kind == 3)
      md5_loads_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(
          static_cast<const uint8_t*>(chars), width, static_cast<const int32_t*>(lens),
          static_cast<const bool*>(valid), sink, rows);
    else
      md5_empty_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(sink, rows);
    return static_cast<int>(cudaGetLastError());
  }}
  if ((width & 15) != 0 || (reinterpret_cast<uintptr_t>(chars) & 15) != 0)
    return md5_rows(chars, width, lens, valid, out, rows, stream);
  const int smem = (kThreads / 32) * 32 * staged_stride(static_cast<int>(width));
  int grid = 0;
  {{
    std::lock_guard<std::mutex> lock(probe_mutex);
    const auto it = staged_grids.find(smem);
    if (it != staged_grids.end()) {{
      grid = it->second;
    }} else {{
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(md5_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, md5_staged_kernel, kThreads,
                                                          smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      grid = sms * per_sm > 0 ? sms * per_sm : 1;
      staged_grids[smem] = grid;
    }}
  }}
  if (blocks > grid) blocks = grid;
  md5_staged_kernel<<<static_cast<int>(blocks), kThreads, smem, s>>>(
      static_cast<const uint8_t*>(chars), static_cast<int>(width),
      static_cast<const int32_t*>(lens), static_cast<const bool*>(valid), sink, rows);
  return static_cast<int>(cudaGetLastError());
}}
"""

#: Beside the current regex source (it includes it): an empty kernel on the
#: parent's search grid (at most 132 x 8 blocks, its shared memory) or the
#: current one; kernels that only load the parent's tables (classes, accept
#: flags, next states) or the fused table into shared memory, or that
#: stages the fused table and reads the rows as the source kernel does but
#: walks nothing; and two variants of the source's walk (one row a thread,
#: 16 bytes a load): (A) two rows a thread, their chunks loaded 64 bytes
#: together and walked interleaved, and (B) a warp's 32 rows staged in
#: shared memory.
SEARCH_PROBE_SOURCE = r"""
#include "{source}"

namespace {{

__global__ void __launch_bounds__(kSearchThreads) search_empty_kernel(uint8_t* sink,
                                                                      long long rows) {{
  if (rows < 0) sink[0] = 1;  // never
}}

__global__ void __launch_bounds__(kSearchThreads)
parent_tables_kernel(const uint8_t* __restrict__ table, const uint8_t* __restrict__ cls,
                     const uint8_t* __restrict__ accept, int states, int classes,
                     uint8_t* __restrict__ sink) {{
  extern __shared__ __align__(16) uint8_t probe_tables[];
  const Dfa d = load(probe_tables, table, cls, accept, states, classes);
  // never (a flag is 0 or 1): keeps the loads
  if (d.accept[threadIdx.x % states] + d.table[threadIdx.x % (states * classes)] == 1000)
    sink[0] = 1;
}}

__global__ void __launch_bounds__(kSearchThreads)
fused_tables_kernel(const uint16_t* __restrict__ fused_g, int states, uint8_t* __restrict__ sink) {{
  extern __shared__ __align__(16) uint8_t probe_fused[];
  const uint16_t* fused = stage_fused(probe_fused, fused_g, states);
  if (fused[threadIdx.x] == 0xffffu) sink[0] = 1;  // never (entries are below 512)
}}

__device__ __forceinline__ int probe_len(int len, long long width) {{
  return len < 0 ? 0 : (len > width ? static_cast<int>(width) : len);
}}

// n of the 16 bytes of chunk v (all for n >= 16, none for n <= 0)
template <bool kAnchoredEnd>
__device__ __forceinline__ void walk16(const uint16_t* fused, const uint4& v, int n, uint32_t& e,
                                       uint32_t& h) {{
  if (n >= 16) {{
    search_word<kAnchoredEnd>(fused, v.x, e, h);
    search_word<kAnchoredEnd>(fused, v.y, e, h);
    search_word<kAnchoredEnd>(fused, v.z, e, h);
    search_word<kAnchoredEnd>(fused, v.w, e, h);
  }} else if (n > 0) {{
    const uint32_t w[4] = {{v.x, v.y, v.z, v.w}};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < n) search_step<kAnchoredEnd>(fused, w[k >> 2], k & 3, e, h);
  }}
}}

// the 16-byte chunks of the n bytes at p that start before n (at most 4), loaded together
__device__ __forceinline__ void load64(const uint8_t* p, int n, uint4 c[4]) {{
#pragma unroll
  for (int q = 0; q < 4; ++q)
    c[q] = 16 * q < n ? *reinterpret_cast<const uint4*>(p + 16 * q) : make_uint4(0, 0, 0, 0);
}}

// Two rows (a of la bytes at pa, b of lb at pb; 16-byte aligned, their width a multiple of
// 16) from entries e* (h*: the accept bits so far), 64 bytes at a time: both rows' chunks
// loaded together, and the 16 bytes both have whole walked interleaved, two independent
// chains of loads.  A row stops at its end, at a hit or at the dead state, tested once
// every 64 bytes.
template <bool kAnchoredEnd>
__device__ __forceinline__ void search_pair(const uint16_t* fused, const uint8_t* pa, int la,
                                            const uint8_t* pb, int lb, int dead, uint32_t& ea,
                                            uint32_t& ha, uint32_t& eb, uint32_t& hb) {{
  for (int j0 = 0;; j0 += 64) {{
    const int na = stopped<kAnchoredEnd>(ea, ha, dead) ? 0 : la - j0;  // bytes left
    const int nb = stopped<kAnchoredEnd>(eb, hb, dead) ? 0 : lb - j0;
    if (na <= 0 && nb <= 0) break;
    uint4 ca[4], cb[4];
    load64(pa + j0, na, ca);
    load64(pb + j0, nb, cb);
#pragma unroll
    for (int q = 0; q < 4; ++q) {{
      const int ma = na - 16 * q, mb = nb - 16 * q;
      if (ma >= 16 && mb >= 16) {{
        const uint32_t wa[4] = {{ca[q].x, ca[q].y, ca[q].z, ca[q].w}};
        const uint32_t wb[4] = {{cb[q].x, cb[q].y, cb[q].z, cb[q].w}};
#pragma unroll
        for (int k = 0; k < 16; ++k) {{
          search_step<kAnchoredEnd>(fused, wa[k >> 2], k & 3, ea, ha);
          search_step<kAnchoredEnd>(fused, wb[k >> 2], k & 3, eb, hb);
        }}
      }} else {{
        walk16<kAnchoredEnd>(fused, ca[q], ma, ea, ha);
        walk16<kAnchoredEnd>(fused, cb[q], mb, eb, hb);
      }}
    }}
  }}
}}

// (A): rows r and r + kSearchThreads of a block's 2 x kSearchThreads (neighbouring lanes
// on neighbouring rows), both rows' chunks loaded 64 bytes together and walked interleaved
template <bool kAnchoredEnd>
__global__ void __launch_bounds__(kSearchThreads)
search2_kernel(const uint8_t* __restrict__ chars, long long width, const int32_t* __restrict__ lens,
               const uint16_t* __restrict__ fused_g, const uint8_t* __restrict__ accept,
               int states, int start, int dead, uint8_t* __restrict__ hit, long long rows) {{
  extern __shared__ __align__(16) uint8_t probe_two[];
  const uint16_t* fused = stage_fused(probe_two, fused_g, states);
  const uint32_t e0 = static_cast<uint32_t>(start) | (accept[start] ? 0x100u : 0u);
  const long long stride = 2LL * gridDim.x * kSearchThreads;
  const bool vec16 = (width & 15) == 0 && (reinterpret_cast<uintptr_t>(chars) & 15) == 0;
  for (long long ra = 2LL * blockIdx.x * kSearchThreads + threadIdx.x; ra < rows;
       ra += stride) {{
    const long long rb = ra + kSearchThreads;
    const bool has_b = rb < rows;
    const int la = probe_len(lens[ra], width);
    const int lb = has_b ? probe_len(lens[rb], width) : 0;
    uint32_t ea = e0, ha = e0, eb = e0, hb = e0;
    if (vec16) {{
      search_pair<kAnchoredEnd>(fused, chars + ra * width, la, chars + rb * width, lb, dead, ea,
                                ha, eb, hb);
    }} else {{
      search_bytes<kAnchoredEnd>(fused, chars + ra * width, la, dead, ea, ha);
      search_bytes<kAnchoredEnd>(fused, chars + rb * width, lb, dead, eb, hb);
    }}
    hit[ra] = search_hit<kAnchoredEnd>(ea, ha);
    if (has_b) hit[rb] = search_hit<kAnchoredEnd>(eb, hb);
  }}
}}

// the source kernel's loads alone: the table staged, each row's length and the 16-byte
// chunks that start before it read, no walk
__global__ void __launch_bounds__(kSearchThreads)
search_loads_kernel(const uint8_t* __restrict__ chars, long long width,
                    const int32_t* __restrict__ lens, const uint16_t* __restrict__ fused_g,
                    int states, uint8_t* __restrict__ sink, long long rows) {{
  extern __shared__ __align__(16) uint8_t probe_loads[];
  const uint16_t* fused = stage_fused(probe_loads, fused_g, states);
  const long long stride = static_cast<long long>(gridDim.x) * kSearchThreads;
  uint32_t x = fused[threadIdx.x];
  for (long long r = static_cast<long long>(blockIdx.x) * kSearchThreads + threadIdx.x;
       r < rows; r += stride) {{
    const int len = probe_len(lens[r], width);
    for (int j0 = 0; j0 < len; j0 += 16) {{
      const uint4 v = *reinterpret_cast<const uint4*>(chars + r * width + j0);
      x ^= v.x ^ v.y ^ v.z ^ v.w;
    }}
  }}
  if (x == 0x9e3779b9u) sink[0] = 1;  // all but never: keeps the loads
}}

// (B): each warp copies its 32 rows' bytes into shared memory with coalesced 16-byte loads
// (none wholly past a row's length; rows padded to an odd count of words), then each lane
// walks its own row from there.  Rows whose width is not a multiple of 16, or not 16-byte
// aligned, are walked from device memory.
template <bool kAnchoredEnd>
__global__ void __launch_bounds__(kSearchThreads)
search_staged_kernel(const uint8_t* __restrict__ chars, int width, const int32_t* __restrict__ lens,
                     const uint16_t* __restrict__ fused_g, const uint8_t* __restrict__ accept,
                     int states, int start, int dead, uint8_t* __restrict__ hit, long long rows) {{
  extern __shared__ __align__(16) uint8_t probe_staged[];
  const uint16_t* fused = stage_fused(probe_staged, fused_g, states);
  const uint32_t e0 = static_cast<uint32_t>(start) | (accept[start] ? 0x100u : 0u);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int stride = tile_stride(width);
  uint8_t* s_rows = probe_staged + states * 512 + warp * 32 * stride;
  const bool vec16 = (width & 15) == 0 && (reinterpret_cast<uintptr_t>(chars) & 15) == 0;
  const long long step = static_cast<long long>(gridDim.x) * kSearchThreads;
  for (long long r0 = (static_cast<long long>(blockIdx.x) * (kSearchThreads / 32) + warp) * 32;
       r0 < rows; r0 += step) {{
    const int nr = rows - r0 < 32 ? static_cast<int>(rows - r0) : 32;
    const long long r = r0 + lane;
    const int len = lane < nr ? probe_len(lens[r], width) : 0;
    if (!vec16) {{
      if (lane < nr) {{
        uint32_t e = e0, h = e0;
        search_bytes<kAnchoredEnd>(fused, chars + r * width, len, dead, e, h);
        hit[r] = search_hit<kAnchoredEnd>(e, h);
      }}
      continue;
    }}
    const uint8_t* src = chars + r0 * width;
    const int chunks = nr * width / 16;
    for (int i0 = 0; i0 < chunks; i0 += 32) {{
      const int i = i0 + lane;
      const int row = 16 * i / width, col = 16 * i - row * width;
      const int row_len = __shfl_sync(0xffffffffu, len, row & 31);
      if (i >= chunks || col >= row_len) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * static_cast<long long>(i));
      uint32_t* d = reinterpret_cast<uint32_t*>(s_rows + row * stride + col);
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }}
    __syncwarp();
    if (lane < nr) {{
      const uint32_t* w = reinterpret_cast<const uint32_t*>(s_rows + lane * stride);
      uint32_t e = e0, h = e0;
      int j = 0;
      for (; j + 16 <= len; j += 16) {{
        if ((!kAnchoredEnd && (h & 0x100u)) || static_cast<int>(e & 0xffu) == dead) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) search_word<kAnchoredEnd>(fused, w[j / 4 + q], e, h);
      }}
      const bool stopped = (!kAnchoredEnd && (h & 0x100u)) || static_cast<int>(e & 0xffu) == dead;
      if (!stopped) {{
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (j + k < len) search_step<kAnchoredEnd>(fused, w[(j + k) / 4], (j + k) & 3, e, h);
      }}
      hit[r] = ((kAnchoredEnd ? e : h) >> 8) & 1u;
    }}
    __syncwarp();
  }}
}}

std::mutex probe_mutex;
std::map<std::pair<int, int>, int> probe_grids;  // (kind, shared memory) -> blocks

template <typename Kernel>
cudaError_t probe_grid(int kind, Kernel kernel, int smem, int& grid) {{
  std::lock_guard<std::mutex> lock(probe_mutex);
  const auto it = probe_grids.find({{kind, smem}});
  if (it != probe_grids.end()) {{
    grid = it->second;
    return cudaSuccess;
  }}
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSearchThreads, smem);
  if (e != cudaSuccess) return e;
  grid = sms * per_sm > 0 ? sms * per_sm : 1;
  probe_grids[{{kind, smem}}] = grid;
  return cudaSuccess;
}}

}}  // namespace

// kind 0: the empty kernel on the parent's grid; 1: the parent's tables loaded, on its
// grid; 2: the empty kernel on the current grid; 3: the fused table loaded, on the current
// grid; 4: variant (A), two rows a thread; 5: variant (B), staged rows; 6: the source
// kernel's loads alone.  The tables as dfa_tables gives them; hit: u8[rows] (a sink for
// kinds 0-3 and 6).
extern "C" int search_probe(int kind, const void* chars, long long width, const void* lens,
                            const void* table, const void* cls, const void* accept,
                            const void* fused, int states, int classes, int start, int dead,
                            int anchored_end, void* hit, long long rows, void* stream) {{
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const uint8_t*>(chars);
  const auto n = static_cast<const int32_t*>(lens);
  const auto f = static_cast<const uint16_t*>(fused);
  const auto ac = static_cast<const uint8_t*>(accept);
  const auto out = static_cast<uint8_t*>(hit);
  long long blocks = (rows + kSearchThreads - 1) / kSearchThreads;
  int grid = 0;
  cudaError_t e = cudaSuccess;
  if (kind <= 3) {{
    const bool parent = kind <= 1;
    const int smem = parent ? 512 + states * classes : states * 512;
    int unused = 0;  // each kernel's attribute set once
    e = probe_grid(0, search_empty_kernel, smem, unused);
    if (e == cudaSuccess) e = probe_grid(1, parent_tables_kernel, smem, unused);
    if (e == cudaSuccess) e = probe_grid(2, fused_tables_kernel, smem, unused);
    grid = 132 * 8;
    if (e == cudaSuccess && !parent) e = search_grid(states, grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks > grid) blocks = grid;
    const int b = static_cast<int>(blocks);
    if (kind == 0 || kind == 2)
      search_empty_kernel<<<b, kSearchThreads, smem, s>>>(out, rows);
    else if (kind == 1)
      parent_tables_kernel<<<b, kSearchThreads, smem, s>>>(
          static_cast<const uint8_t*>(table), static_cast<const uint8_t*>(cls), ac, states,
          classes, out);
    else
      fused_tables_kernel<<<b, kSearchThreads, smem, s>>>(f, states, out);
    return static_cast<int>(cudaGetLastError());
  }}
  if (kind == 6) {{  // the loads alone, grid for grid with the source kernel
    e = probe_grid(8, search_loads_kernel, states * 512, grid);
    if (e == cudaSuccess) e = search_grid(states, grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks > grid) blocks = grid;
    search_loads_kernel<<<static_cast<int>(blocks), kSearchThreads, states * 512, s>>>(
        c, width, n, f, states, out, rows);
    return static_cast<int>(cudaGetLastError());
  }}
  if (kind == 4) {{
    const auto kernel = anchored_end ? search2_kernel<true> : search2_kernel<false>;
    e = probe_grid(4 + anchored_end, kernel, states * 512, grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = (rows + 2 * kSearchThreads - 1) / (2 * kSearchThreads);
    if (blocks > grid) blocks = grid;
    kernel<<<static_cast<int>(blocks), kSearchThreads, states * 512, s>>>(
        c, width, n, f, ac, states, start, dead, out, rows);
    return static_cast<int>(cudaGetLastError());
  }}
  const int smem = states * 512 + (kSearchThreads / 32) * 32 * tile_stride(static_cast<int>(width));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = anchored_end ? search_staged_kernel<true> : search_staged_kernel<false>;
  e = probe_grid(6 + anchored_end, kernel, smem, grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks > grid) blocks = grid;
  kernel<<<static_cast<int>(blocks), kSearchThreads, smem, s>>>(
      c, static_cast<int>(width), n, f, ac, states, start, dead, out, rows);
  return static_cast<int>(cudaGetLastError());
}}
"""


def md5_fn(lib, parent: bool):
    """fn(chars, lens, valid=None, out=None, rows=None) -> out through
    ``lib``'s ``md5_rows``, as the wrapper does: the output allocated (or
    ``out``), then the launch over the first ``rows`` rows (all by
    default).  A parent's interface has no ``valid``: it hashes every
    row."""
    lib.md5_rows.argtypes = ([VP, LL, VP, VP, LL, VP] if parent
                             else [VP, LL, VP, VP, VP, LL, VP])
    lib.md5_rows.restype = I

    def fn(chars, lens, valid=None, out=None, rows=None):
        if out is None:
            out = torch.empty(chars.shape[0], 32, dtype=torch.uint8,
                              device="cuda")
        extra = [] if parent else [None if valid is None
                                   else valid.data_ptr()]
        err = lib.md5_rows(chars.data_ptr(), chars.shape[1], lens.data_ptr(),
                           *extra, out.data_ptr(),
                           chars.shape[0] if rows is None else rows,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"md5_rows launch failed: {err}")
        return out
    return fn


def md5_probe_fn(lib, kind: int):
    """fn(chars, lens, valid=None, out=None): one launch of
    ``MD5_PROBE_SOURCE``'s kind (0, 1: the empty kernel on the parent's or
    the current grid; 2: the staged variant (B))."""
    lib.md5_probe.argtypes = [I, VP, LL, VP, VP, VP, LL, VP]
    lib.md5_probe.restype = I

    def fn(chars, lens, valid=None, out=None):
        if out is None:
            out = torch.empty(chars.shape[0], 32, dtype=torch.uint8,
                              device="cuda")
        err = lib.md5_probe(kind, chars.data_ptr(), chars.shape[1],
                            lens.data_ptr(),
                            None if valid is None else valid.data_ptr(),
                            out.data_ptr(), chars.shape[0],
                            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"md5_probe {kind} launch failed: {err}")
        return out
    return fn


def search_fn(lib, parent: bool):
    """fn(dfa, chars, lens, out=None) -> bool hits through ``lib``'s
    ``dfa_search``, as the wrapper does (a parent's interface takes the
    classes, the next states and the accept flags; the current one the
    fused table)."""
    lib.dfa_search.argtypes = ([VP, LL, VP, VP, VP, VP, I, I, I, I, I, VP,
                                LL, VP] if parent else
                               [VP, LL, VP, VP, VP, I, I, I, I, VP, LL, VP])
    lib.dfa_search.restype = I

    def fn(dfa, chars, lens, out=None):
        if out is None:
            out = torch.empty(chars.shape[0], dtype=torch.bool,
                              device="cuda")
        tables = ([dfa["table"].data_ptr(), dfa["cls"].data_ptr(),
                   dfa["accept"].data_ptr(), dfa["states"], dfa["classes"]]
                  if parent else [dfa["fused"].data_ptr(),
                                  dfa["accept"].data_ptr(), dfa["states"]])
        err = lib.dfa_search(chars.data_ptr(), chars.shape[1],
                             lens.data_ptr(), *tables, dfa["start"],
                             dfa["dead"], int(dfa["anchored_end"]),
                             out.data_ptr(), chars.shape[0],
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dfa_search launch failed: {err}")
        return out
    return fn


def search_probe_fn(lib, kind: int):
    """fn(dfa, chars, lens, out=None): one launch of
    ``SEARCH_PROBE_SOURCE``'s kind (0-3 the launch and table probes, 4
    variant (A), 5 variant (B))."""
    lib.search_probe.argtypes = [I, VP, LL, VP, VP, VP, VP, VP, I, I, I, I,
                                 I, VP, LL, VP]
    lib.search_probe.restype = I

    def fn(dfa, chars, lens, out=None):
        if out is None:
            out = torch.empty(chars.shape[0], dtype=torch.bool,
                              device="cuda")
        err = lib.search_probe(
            kind, chars.data_ptr(), chars.shape[1], lens.data_ptr(),
            dfa["table"].data_ptr(), dfa["cls"].data_ptr(),
            dfa["accept"].data_ptr(), dfa["fused"].data_ptr(), dfa["states"],
            dfa["classes"], dfa["start"], dfa["dead"],
            int(dfa["anchored_end"]), out.data_ptr(), chars.shape[0],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"search_probe {kind} launch failed: {err}")
        return out
    return fn


def record_md5_search_calls(rows: int) -> dict:
    """The md5 and dfa_search calls of phase 3p's md5(o_comment) and
    o_comment RLIKE items (their SQL over the same generated orders, 4
    partitions, at ``rows`` lineitem rows), with each item's bound."""
    import spark_rapids_tpu_torch as srt
    od = cs.make_tpch_tables(rows)["orders"]
    sess = srt.session()
    sess.create_dataframe({k: od[k] for k in ("o_orderkey", "o_comment")},
                          num_partitions=cs.STRING_PARTITIONS
                          ).createOrReplaceTempView("orders")
    oc_lens = np.array([len(c.encode()) for c in cs.TPCH_ORDER_COMMENTS]
                       )[cs._comment_index(od["o_comment"])]
    items = {"md5": ("md5", "SELECT md5(o_comment) h, count(*) n FROM "
                     "orders GROUP BY h ORDER BY h", 0),
             "rlike": ("dfa_search", "SELECT count(*) n FROM orders WHERE "
                       "o_comment RLIKE 'special.*requests'", 1)}
    out = {}
    for label, (name, sql, at) in items.items():
        calls: list = []
        with cs.recording(K, name, calls, lambda a, at=at: a[at].is_cuda):
            sess.sql(sql).collect()
        torch.cuda.synchronize()
        nbytes, ops = cs.string_tail_work(name, calls, lens=oc_lens)
        b, o = nbytes / cs.HBM_BYTES_PER_S, ops / cs.INT_OPS_PER_S
        out[label] = dict(name=name, calls=calls, bound_ms=max(b, o) * 1e3,
                          bound_by="operations" if o > b else "bytes")
    return out


def synthetic_rows(width: int, seed: int, alphabet=None):
    """``SWEEP_ROWS`` rows of 0 to ``width`` bytes on the card (check_md5's
    and check_dfa's shapes): (chars, lens)."""
    rng = np.random.default_rng(seed)
    chars, lens = cs.string_rows(rng, rng.integers(0, width + 1, SWEEP_ROWS),
                                 width, alphabet)
    return torch.from_numpy(chars).cuda(), torch.from_numpy(lens).cuda()


def block_lines(src: str, marker: str, after: str = "") -> set:
    """The lines (1-based) of the braced block that opens on the first line
    holding ``marker`` (after the first line holding ``after``)."""
    lines = src.splitlines()
    start = next(i for i, line in enumerate(lines) if after in line)
    first = next(i for i in range(start, len(lines)) if marker in lines[i])
    depth = 0
    for j in range(first, len(lines)):
        depth += lines[j].count("{") - lines[j].count("}")
        if depth == 0 and "{" in "".join(lines[first:j + 1]):
            return set(range(first + 1, j + 2))
    return set()


def marker_lines(src: str, first: str, last: str) -> set:
    """The lines (1-based) from the first line holding ``first`` to the
    next one holding ``last``."""
    lines = src.splitlines()
    a = next(i for i, line in enumerate(lines) if first in line)
    b = next(i for i in range(a, len(lines)) if last in lines[i])
    return set(range(a + 1, b + 2))


def disassemble(src_path: Path, build_dir: Path, label: str) -> str:
    """``nvdisasm`` with line info of a ``-lineinfo`` cubin of
    ``src_path`` (line info does not change the code), also written to
    ``build_dir/<label>.sass``."""
    cubin = build_dir / f"{label}.cubin"
    flags = [f for f in K.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                  "-fPIC")]
    proc = subprocess.run([K._nvcc(), *flags, "-cubin", "-lineinfo", "-o",
                           str(cubin), str(src_path)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed: {proc.stderr}")
    nvdisasm = str(Path(K._nvcc()).parent / "nvdisasm")
    for flags in (["-gi", "-c"], ["-g", "-c"], ["-g"]):
        dis = subprocess.run([nvdisasm, *flags, str(cubin)],
                             capture_output=True, text=True)
        if dis.returncode == 0 and "//##" in dis.stdout:
            break
    if dis.returncode != 0:
        raise RuntimeError(f"nvdisasm failed: {dis.stderr}")
    cubin.with_suffix(".sass").write_text(dis.stdout)
    return dis.stdout


def region_counts(sass: str, regions: dict, kernel) -> dict:
    """SASS instructions of the kernels whose section name ``kernel(name)``
    accepts, by region: ``regions`` maps a name to source lines, and an
    instruction goes to the region of its innermost source line, or else
    of the nearest call site it was inlined at that lies in one (nvdisasm
    prints an inlined line's chain one call site a line, innermost first);
    the rest is ``rest``."""
    out = {"total": 0, "rest": 0, **{r: 0 for r in regions}}
    keep, pending, where = False, [], ()
    for text in sass.splitlines():
        m = re.match(r"\s*\.text\.(\S+):", text)
        if m:
            keep = kernel(m.group(1))
            continue
        m = re.search(r'//## File ".*?", line (\d+)(.*)', text)
        if m:
            pending.append((int(m.group(1)),
                            *map(int, re.findall(r"line (\d+)", m.group(2)))))
            continue
        if not keep or not re.match(r"\s*/\*[0-9a-f]{4}\*/\s+\S", text):
            continue
        if pending:
            where = tuple(line for p in pending for line in p)
            pending = []
        out["total"] += 1
        region = next((r for line in where for r, ls in regions.items()
                       if line in ls), "rest")
        out[region] += 1
    return out


def md5_sass(parent: Path | None, current: Path, build_dir: Path) -> dict:
    """SASS instructions of md5's kernel by region, for a one-block row:
    the loads and tail words, the 64 steps (the current source's also the
    four state adds), the hex output.  The current source is built with
    the 16-byte path alone (its byte path is a second copy of the steps)."""
    out = {}
    src = current.read_text()
    vec_only = build_dir / "md5_vec_only.cu"
    edited(current, (("""    if (vec16)
      md5_row<true>(p, len, st);
    else
      md5_row<false>(p, len, st);""", "    md5_row<true>(p, len, st);"),),
           vec_only)
    regions = {"loads and tail words": set().union(
        *(function_lines(src, f) for f in ("block_words_vec",
                                           "block_words_bytes", "end_word"))),
        "steps and state adds": set(function_lines(src, "md5_block")),
        "hex": set().union(*(function_lines(src, f)
                             for f in ("store_hex", "hex_digits")))}
    out["current"] = region_counts(disassemble(vec_only, build_dir,
                                               "md5_current"), regions,
                                   lambda n: "md5_kernel" in n)
    if parent is not None:
        psrc = parent.read_text()
        steps = marker_lines(psrc, "uint32_t a = a0, bb = b0", "d0 += d;")
        regions = {"loads and tail words": set(function_lines(psrc, "word"))
                   | (marker_lines(psrc, "uint32_t m[16];",
                                   "uint32_t a = a0, bb = b0") - steps),
                   "steps and state adds": steps,
                   "hex": marker_lines(psrc, "const uint32_t h[4]",
                                       "o[1] = make_uint4")}
        out["parent"] = region_counts(disassemble(parent, build_dir,
                                                  "md5_parent"), regions,
                                      lambda n: "md5_kernel" in n)
    return out


def search_sass(parent: Path | None, current: Path, build_dir: Path) -> dict:
    """SASS instructions of dfa_search's kernel (not anchored at its end)
    in the walk of a whole 16-byte chunk (static: every instruction its
    lines compile to), and a byte's share of it, the current source's and
    the parent's."""
    out = {}
    for label, src, marker, after, kernel in (
            ("current", current, "for (; j0 + 16 <= len && !stopped<", "",
             lambda n: "dfa_search_kernelILb0E" in n),
            ("parent", parent, "for (int k = 0; k < 16; ++k) {",
             "16 bytes a load, walked from registers",
             lambda n: "dfa_search_kernel" in n and "ILb" not in n)):
        if src is None:
            continue
        walk = block_lines(src.read_text(), marker, after=after)
        got = region_counts(disassemble(src, build_dir, f"search_{label}"),
                            {"16 bytes": walk}, kernel)
        out[label] = dict(got, per_byte=got["16 bytes"] / 16)
    return out


def md5_search_main(argv) -> int:
    """``--mode md5_search``: md5 and dfa_search on the calls of phase 3p's
    md5(o_comment) and o_comment RLIKE items (recorded from the same SQL,
    4 partitions of 2^19 rows at SF1, 375,000 live), each launch after the
    L2 flush that reads, against the parents ``--parent-md5`` and
    ``--parent-regex`` (earlier sources: md5's without ``valid``, the
    search's with the class, next-state and accept tables).  It prints,
    one JSON line each, after the card's name and power limit:

    - ``md5_split``: over the item's 4 calls, an empty kernel on the
      parent's grid and on the current one, the parent's bare launch (into
      outputs allocated once), the same with only the live rows passed
      (``rows`` = the call's valid count, a probe), a kernel that only
      reads each valid row's chunks and writes its 32 bytes (no hash) on
      the current grid, the current bare launch; each bare launch's host
      microseconds (200 enqueued);
    - ``search_split``: over the RLIKE's 4 calls, an empty kernel, one that
      only loads the tables into shared memory, and the bare launch, each
      for the parent (its grid, its three tables) and the current kernel
      (its grid, the fused table), and for the current one a kernel that
      stages the table and reads the rows but walks nothing; host
      microseconds as above;
    - ``md5_sweep`` and ``search_sweep``: ptxas's registers and spills and
      the ms (twice, the builds in one order then the other) of each build
      on the recorded calls and on synthetic batches of ``SWEEP_ROWS``
      rows (md5 at check_md5's widths 128 and 130; the search at check_dfa's
      16, 64 and 200 with its alphabet): md5 ``thread`` (the source: each
      thread loads its own row, 16 bytes a load: variant (A)) and ``staged``
      (``MD5_PROBE_SOURCE``: variant (B)); the search ``one_row`` (the
      source: a row a thread, 16 bytes a load), ``two_rows`` and ``staged``
      (``SEARCH_PROBE_SOURCE``: variants (A) and (B)); and copies of each
      source with its threads a block edited (``MD5_BUILDS``,
      ``SEARCH_BUILDS``), each checked against the plain version first;
    - ``ab``: parent, current, current, parent on both items, wrappers
      included, with the bounds ``chip_smoke.py`` gives them and each share;
    - ``sass``: both kernels' SASS by region (:func:`md5_sass`,
      :func:`search_sass`), parent and current, and the disassembly in
      ``build_dir``."""
    parent_md5 = arg(argv, "--parent-md5")
    parent_regex = arg(argv, "--parent-regex")
    parent_md5 = Path(parent_md5) if parent_md5 else None
    parent_regex = Path(parent_regex) if parent_regex else None
    build_dir = Path(arg(argv, "--build-dir", ROOT / "build" / "strings_ab"))
    rows = int(arg(argv, "--rows", cs.SF1_LINEITEM))
    build_dir.mkdir(parents=True, exist_ok=True)
    card = cs.nvidia_smi_card()
    print(card, flush=True)
    md5_src, regex_src = K.CSRC / "md5.cu", K.CSRC / "regex_dfa.cu"
    jobs = {f"md5 {k}": (edited(md5_src, e, build_dir / f"md5_{k}.cu"),
                         build_dir / f"libmd5_{k}.so")
            for k, e in MD5_BUILDS.items()}
    jobs.update({f"search {k}": (edited(regex_src, e,
                                        build_dir / f"search_{k}.cu"),
                                 build_dir / f"libsearch_{k}.so")
                 for k, e in SEARCH_BUILDS.items()})
    jobs["md5 current"] = (md5_src, build_dir / "libmd5.so")
    jobs["search current"] = (regex_src, build_dir / "libsearch.so")
    for name, text, src in (("md5_probe", MD5_PROBE_SOURCE, md5_src),
                            ("search_probe", SEARCH_PROBE_SOURCE, regex_src)):
        probe = build_dir / f"{name}.cu"
        probe.write_text(text.format(source=src.resolve()))
        jobs[name] = (probe, build_dir / f"lib{name}.so")
    if parent_md5:
        jobs["md5 parent"] = (parent_md5, build_dir / "libmd5_parent.so")
    if parent_regex:
        jobs["search parent"] = (parent_regex,
                                 build_dir / "libsearch_parent.so")
    with ThreadPoolExecutor(len(jobs) + 2) as pool:
        built = {k: pool.submit(nvcc, *v) for k, v in jobs.items()}
        sass = {"md5": pool.submit(md5_sass, parent_md5, md5_src, build_dir),
                "search": pool.submit(search_sass, parent_regex, regex_src,
                                      build_dir)}
        built = {k: f.result() for k, f in built.items()}
    lib = {k: ctypes.CDLL(str(v[0])) for k, v in built.items()}

    items = record_md5_search_calls(rows)
    md5_calls, rlike_calls = items["md5"]["calls"], items["rlike"]["calls"]
    dfa = rlike_calls[0][0]
    synth = {"w128": synthetic_rows(128, 1),
             "w130": synthetic_rows(130, 2)}
    alphabet = b"abcdxyz0123456789 special requests"
    ssynth = {f"w{w}": synthetic_rows(w, w, alphabet) for w in (16, 64, 200)}
    md5_inputs = {"o_comment": md5_calls,
                  **{k: [v] for k, v in synth.items()}}
    search_inputs = {"rlike": rlike_calls,
                     **{k: [(dfa, *v)] for k, v in ssynth.items()}}

    md5s = {"thread": md5_fn(lib["md5 current"], False),
            "staged": md5_probe_fn(lib["md5_probe"], 2),
            **{k: md5_fn(lib[f"md5 {k}"], False) for k in MD5_BUILDS}}
    searches = {"one_row": search_fn(lib["search current"], False),
                "two_rows": search_probe_fn(lib["search_probe"], 4),
                "staged": search_probe_fn(lib["search_probe"], 5),
                **{k: search_fn(lib[f"search {k}"], False)
                   for k in SEARCH_BUILDS}}
    parent = {}
    if parent_md5:
        parent["md5"] = md5_fn(lib["md5 parent"], True)
    if parent_regex:
        parent["search"] = search_fn(lib["search parent"], True)

    def check_md5(fn, calls, label, hashes_all=False):
        for args in calls:
            got, want = fn(*args), K.md5_plain(*args)
            if hashes_all and len(args) > 2 and args[2] is not None:
                got = torch.where(args[2][:, None], got, 0)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"md5 {label}: kernel != plain")

    def check_search(fn, calls, label):
        for args in calls:
            got, want = fn(*args), K.dfa_search_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"dfa_search {label}: kernel != plain")

    for k, fn in md5s.items():
        for item, calls in md5_inputs.items():
            check_md5(fn, calls, f"{k} {item}")
    for k, fn in searches.items():
        for item, calls in search_inputs.items():
            check_search(fn, calls, f"{k} {item}")
    if "md5" in parent:
        check_md5(parent["md5"], md5_calls, "parent", hashes_all=True)
    if "search" in parent:
        check_search(parent["search"], rlike_calls, "parent")

    # the splits
    outs = [torch.empty(a[0].shape[0], 32, dtype=torch.uint8, device="cuda")
            for a in md5_calls]
    live = [int(a[2].sum()) for a in md5_calls]
    row = {"live_rows": live, "rows": [a[0].shape[0] for a in md5_calls]}
    for key, kind in (("parent_grid_empty_ms", 0),
                      ("current_grid_empty_ms", 1),
                      ("current_loads_stores_only_ms", 3)):
        fn = md5_probe_fn(lib["md5_probe"], kind)
        row[key] = sum(cs.cuda_ms(lambda: fn(*a, out=o), flush_l2=True)
                       for a, o in zip(md5_calls, outs))
    cur = md5s["thread"]
    row["current_bare_ms"] = sum(cs.cuda_ms(lambda: cur(*a, out=o),
                                            flush_l2=True)
                                 for a, o in zip(md5_calls, outs))
    row["current_bare_host_us"] = host_us(
        lambda a, o: cur(*a, out=o), list(zip(md5_calls, outs)))
    if "md5" in parent:
        p = parent["md5"]
        row["parent_bare_ms"] = sum(cs.cuda_ms(lambda: p(*a, out=o),
                                               flush_l2=True)
                                    for a, o in zip(md5_calls, outs))
        row["parent_live_rows_only_ms"] = sum(
            cs.cuda_ms(lambda: p(*a, out=o, rows=n), flush_l2=True)
            for a, o, n in zip(md5_calls, outs, live))
        row["parent_bare_host_us"] = host_us(
            lambda a, o: p(*a, out=o), list(zip(md5_calls, outs)))
    print(json.dumps({"md5_split": row, "card": card}), flush=True)

    hits = [torch.empty(a[1].shape[0], dtype=torch.bool, device="cuda")
            for a in rlike_calls]
    row = {"states": dfa["states"], "classes": dfa["classes"],
           "dead": dfa["dead"], "rows": [a[1].shape[0] for a in rlike_calls]}
    for key, kind in (("parent_grid_empty_ms", 0),
                      ("parent_tables_only_ms", 1),
                      ("current_grid_empty_ms", 2),
                      ("current_tables_only_ms", 3),
                      ("current_loads_only_ms", 6)):
        fn = search_probe_fn(lib["search_probe"], kind)
        row[key] = sum(cs.cuda_ms(lambda: fn(*a, out=o), flush_l2=True)
                       for a, o in zip(rlike_calls, hits))
    fns = {"current": searches["one_row"], **(
        {"parent": parent["search"]} if "search" in parent else {})}
    for k, fn in fns.items():
        row[f"{k}_bare_ms"] = sum(cs.cuda_ms(lambda: fn(*a, out=o),
                                             flush_l2=True)
                                  for a, o in zip(rlike_calls, hits))
        row[f"{k}_bare_host_us"] = host_us(
            lambda a, o: fn(*a, out=o), list(zip(rlike_calls, hits)))
    print(json.dumps({"search_split": row, "card": card}), flush=True)
    del outs, hits

    def sweep(builds, inputs, ptxas_of):
        res = {k: {"ptxas": ptxas_of(k),
                   **{f"{item}_ms": [] for item in inputs}} for k in builds}
        for k in list(builds) + list(builds)[::-1]:
            for item, calls in inputs.items():
                res[k][f"{item}_ms"].append(item_ms(builds[k], calls))
        return res

    def ptxas(label, lib_key, match):
        return [{"kernel": f, "registers": r, "spill_bytes": s + lo}
                for f, r, s, lo in cs.spill_report(built[lib_key][1])
                if match(f)]
    md5_libs = {"thread": "md5 current", "staged": "md5_probe",
                **{k: f"md5 {k}" for k in MD5_BUILDS}}
    print(json.dumps({"md5_sweep": sweep(md5s, md5_inputs, lambda k: ptxas(
        k, md5_libs[k], lambda f: ("md5_staged" if k == "staged" else
                                   "md5_kernel") in f)), "card": card}),
          flush=True)
    search_libs = {"one_row": "search current", "two_rows": "search_probe",
                   "staged": "search_probe",
                   **{k: f"search {k}" for k in SEARCH_BUILDS}}
    search_match = {"two_rows": lambda f: "search2" in f,
                    "staged": lambda f: "search_staged" in f}
    print(json.dumps({"search_sweep": sweep(
        searches, search_inputs, lambda k: ptxas(
            k, search_libs[k], search_match.get(
                k, lambda f: "dfa_search_kernel" in f))), "card": card}),
        flush=True)

    order = ["parent", "current", "current", "parent"] if parent else \
        ["current", "current"]
    ab = {k: [] for k in order}
    kernels = {"current": {"md5": md5s["thread"],
                           "search": searches["one_row"]}, "parent": parent}
    for label in order:
        got = {}
        if "md5" in kernels[label]:
            got["md5"] = item_ms(kernels[label]["md5"], md5_calls)
        if "search" in kernels[label]:
            got["rlike"] = item_ms(kernels[label]["search"], rlike_calls)
        ab[label].append(got)
    bounds = {k: {"bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
                  "launches": len(v["calls"])} for k, v in items.items()}
    for k, runs in ab.items():
        for item in bounds:
            ms = [r[item] for r in runs if item in r]
            if ms:
                bounds[item][f"{k}_share"] = [bounds[item]["bound_ms"] / t
                                              for t in ms]
    print(json.dumps({"ab": ab, "bounds": bounds, "card": card}), flush=True)
    print(json.dumps({"sass": {k: f.result() for k, f in sass.items()},
                      "md5_ops_bound": cs.MD5_OPS_PER_BLOCK,
                      "dfa_ops_bound": cs.DFA_OPS_PER_BYTE, "card": card}),
          flush=True)
    return 0


def main(argv) -> int:
    mode = arg(argv, "--mode", "spans_dtoa")
    if mode not in ("spans_dtoa", "md5_search"):
        raise SystemExit(f"--mode {mode}: spans_dtoa or md5_search")
    return (md5_search_main if mode == "md5_search" else
            spans_dtoa_main)(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
