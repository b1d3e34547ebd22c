"""Time the span kernel ``dfa_match_spans`` (``spark_rapids_tpu_torch/csrc/
regex_dfa.cu``) and the shortest-digits kernel ``dtoa_shortest``
(``csrc/dtoa.cu``) against earlier versions of their sources, over the span
kernel's two kernels and tile sizes, in one process on one CUDA card.

    python3 tools/strings_ab.py [--parent-regex OLD_REGEX_DFA_CU]
                                [--parent-dtoa OLD_DTOA_CU] [--build-dir DIR]
                                [--rows LINEITEM_ROWS]

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


def main(argv) -> int:
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


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
