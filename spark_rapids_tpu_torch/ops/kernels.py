"""Hand-written Hopper kernels and their plain PyTorch versions.

The JAX package's Pallas kernels (``spark_rapids_tpu/ops/pallas_kernels.py``)
become CUDA C++ sources under ``csrc/``, compiled with ``nvcc`` for sm_90a into
a shared library with a plain C interface, loaded with ctypes.  The build runs
at first use, from the package's own sources, into ``build/torch_kernels/``
beside the package; the file name carries a hash of the source and flags, so
an edited source is rebuilt.

Every kernel has three parts here:

* a plain PyTorch version of the same function (the CPU path, and what the
  kernel is checked against on the card);
* a wrapper that checks its inputs, allocates outputs and scratch, launches on
  the current stream and raises on a launch error.  A CPU tensor takes the
  plain version; a CUDA tensor launches the kernel or raises — there is no
  fallback;
* a launch count in :data:`LAUNCHES`, raised by one where the wrapper
  launches and nowhere else, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES = {"seg_sum_f32": 0, "seg_sum_f64": 0, "murmur3_long": 0,
            "pcg64": 0, "md5": 0, "dtoa_shortest": 0, "dfa_search": 0,
            "dfa_match_spans": 0}

#: the largest group table the segmented-sum kernel takes (the aggregate's
#: small-table limit, ``_MATMUL_MAX_GROUPS`` in the JAX package)
SEG_SUM_MAX_GROUPS = 256

_LIBS: dict = {}
#: (threads, device index) -> pcg64's jump tables on that device
_PCG64_TABLES: dict = {}
#: (float?, device index) -> the dtoa tables on that device
_DTOA_TABLES: dict = {}
_LIB_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library (once per source and
    flags) and return its path.  What ptxas reports for each kernel
    (registers, stack, spills) is kept beside it: :func:`ptxas_report`."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` output of the build of ``csrc/<name>.cu``."""
    return build(name).with_suffix(".ptxas.txt").read_text()


def _lib(name: str) -> ctypes.CDLL:
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _bind(name, lib)
            _LIBS[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "murmur3":
        lib.murmur3_long.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_uint, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p]
        lib.murmur3_long.restype = ctypes.c_int
        return
    if name == "pcg64":
        for fn in ("pcg64_stride", "pcg64_rows_per_thread"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = ctypes.c_int
        lib.pcg64_uniform.argtypes = [ctypes.c_void_p] + [
            ctypes.c_ulonglong] * 8 + [ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_void_p]
        lib.pcg64_uniform.restype = ctypes.c_int
        return
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "md5":
        lib.md5_rows.argtypes = [vp, ll, vp, vp, vp, ll, vp]
        lib.md5_rows.restype = i
        return
    if name == "dtoa":
        lib.dtoa_shortest.argtypes = [vp, i, ll, vp, vp, vp, i, i, i, vp, vp,
                                      vp, vp]
        lib.dtoa_shortest.restype = i
        return
    if name == "regex_dfa":
        lib.dfa_search.argtypes = [vp, ll, vp, vp, vp, i, i, i, i, vp, ll,
                                   vp]
        lib.dfa_search.restype = i
        lib.dfa_match_spans.argtypes = [vp, ll, vp, vp, vp, vp, i, i, i, i, i,
                                        i, vp, vp, ll, vp]
        lib.dfa_match_spans.restype = i
        lib.dfa_spans_path.argtypes = [ll, i, i]
        lib.dfa_spans_path.restype = i
        return
    if name != "seg_sum":
        raise ValueError(f"no C interface declared for {name}")
    for fn in ("seg_sum_f32", "seg_sum_f64"):
        scratch = getattr(lib, f"{fn}_scratch")
        scratch.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        scratch.restype = ctypes.c_longlong
        launch = getattr(lib, fn)
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p]
        launch.restype = ctypes.c_int


# --------------------------------------------------------------------------
# segmented sum: replaces seg_sum_f32_pallas (pallas_kernels.py:126); the
# float64 build takes the double SUM slots the JAX package leaves to seg_sum2
# --------------------------------------------------------------------------

def seg_sum_plain(values: torch.Tensor, rank: torch.Tensor,
                  out_size: int) -> torch.Tensor:
    """[s, n] values + int32[n] ranks -> [s, out_size] sums in the values'
    type; ranks outside [0, out_size) add nothing (they go to a spare column
    that is cut off: torch scatters raise on out-of-range indices where jnp
    scatters drop them)."""
    s = values.shape[0]
    idx = torch.where((rank >= 0) & (rank < out_size), rank,
                      out_size).to(torch.int64)
    out = torch.zeros(s, out_size + 1, dtype=values.dtype,
                      device=values.device)
    out.index_add_(1, idx, values)
    return out[:, :out_size]


#: the plain version of each build
seg_sum_f32_plain = seg_sum_f64_plain = seg_sum_plain


def _seg_sum(name: str, dtype: torch.dtype, values: torch.Tensor,
             rank: torch.Tensor, out_size: int) -> torch.Tensor:
    out_size = int(out_size)
    if values.dim() != 2 or rank.dim() != 1 or \
            values.shape[1] != rank.shape[0]:
        raise ValueError(f"{name}: values [s, n] and rank [n] expected, "
                         f"got {tuple(values.shape)} and {tuple(rank.shape)}")
    if values.dtype != dtype or rank.dtype != torch.int32:
        raise TypeError(f"{name}: {dtype} values and int32 rank expected, "
                        f"got {values.dtype} and {rank.dtype}")
    if not 1 <= out_size <= SEG_SUM_MAX_GROUPS:
        raise ValueError(f"{name}: out_size {out_size} outside "
                         f"[1, {SEG_SUM_MAX_GROUPS}]")
    if values.device != rank.device:
        raise ValueError(f"{name}: values and rank on different devices")
    if values.device.type == "cpu":
        return seg_sum_plain(values, rank, out_size)
    if values.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {values.device}")
    if not (values.is_contiguous() and rank.is_contiguous()):
        raise ValueError(f"{name}: contiguous tensors expected")
    s, n = values.shape
    lib = _lib("seg_sum")
    with torch.cuda.device(values.device):
        scratch = torch.empty(getattr(lib, f"{name}_scratch")(n, s, out_size),
                              dtype=dtype, device=values.device)
        out = torch.empty(s, out_size, dtype=dtype, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = getattr(lib, name)(values.data_ptr(), rank.data_ptr(),
                                 scratch.data_ptr(), out.data_ptr(), s, n,
                                 out_size, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def seg_sum_f32(values: torch.Tensor, rank: torch.Tensor,
                out_size: int) -> torch.Tensor:
    """Per-group sums of ``s`` float32 value rows by group rank (see
    ``csrc/seg_sum.cu``).  CPU tensors take :func:`seg_sum_f32_plain`."""
    return _seg_sum("seg_sum_f32", torch.float32, values, rank, out_size)


def seg_sum_f64(values: torch.Tensor, rank: torch.Tensor,
                out_size: int) -> torch.Tensor:
    """Per-group sums of ``s`` float64 value rows by group rank, the same
    kernel built for doubles.  CPU tensors take :func:`seg_sum_f64_plain`."""
    return _seg_sum("seg_sum_f64", torch.float64, values, rank, out_size)


# --------------------------------------------------------------------------
# murmur3 over int64: replaces murmur3_long_pallas (pallas_kernels.py:64)
# --------------------------------------------------------------------------
#
# The plain version works on uint32 values held in int64 tensors: torch on
# the CPU has no shifts for uint32.  Every step masks back to 32 bits, and a
# multiply by a 32-bit constant goes in two 16-bit halves, so no int64
# intermediate overflows.

M32 = 0xFFFFFFFF


def u32_mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return u32_mul(rotl32(u32_mul(k1, 0xcc9e2d51), 15), 0x1b873593)


def mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    return (rotl32(h1 ^ k1, 13) * 5 + 0xe6546b64) & M32


def fmix32(h1: torch.Tensor, length: int) -> torch.Tensor:
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = u32_mul(h1, 0x85ebca6b)
    h1 = h1 ^ (h1 >> 13)
    h1 = u32_mul(h1, 0xc2b2ae35)
    return h1 ^ (h1 >> 16)


def as_u32(seed, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-row seed (int32 or uint32 bits) as uint32 values in
    int64, broadcast to ``like``."""
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int64) & M32
    return torch.full_like(like, int(seed) & M32, dtype=torch.int64)


def to_int32_bits(h_u32: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the int32 with the same bits."""
    return torch.where(h_u32 >= 1 << 31, h_u32 - (1 << 32), h_u32
                       ).to(torch.int32)


def murmur3_long_plain(values: torch.Tensor, seed) -> torch.Tensor:
    """int64[n] values, seed scalar or int32/uint32[n] -> int32[n] Spark
    murmur3 ``hashLong``: the bits of ``ops/hashing.murmur3_long`` in the
    JAX package."""
    low = values & M32
    high = (values >> 32) & M32
    h1 = mix_h1(as_u32(seed, values), mix_k1(low))
    h1 = mix_h1(h1, mix_k1(high))
    return to_int32_bits(fmix32(h1, 8))


def murmur3_long(values: torch.Tensor, seed) -> torch.Tensor:
    """Spark murmur3 of int64 rows with a scalar or per-row seed (see
    ``csrc/murmur3.cu``).  CPU tensors take :func:`murmur3_long_plain`."""
    if values.dim() != 1 or values.dtype != torch.int64:
        raise TypeError(f"murmur3_long: int64[n] values expected, got "
                        f"{values.dtype}{list(values.shape)}")
    per_row = isinstance(seed, torch.Tensor)
    if per_row:
        if seed.dtype not in (torch.int32, torch.uint32) or \
                seed.shape != values.shape:
            raise TypeError(f"murmur3_long: int32/uint32 seeds of shape "
                            f"{list(values.shape)} expected, got "
                            f"{seed.dtype}{list(seed.shape)}")
        if seed.device != values.device:
            raise ValueError("murmur3_long: values and seeds on different "
                             "devices")
    if values.device.type == "cpu":
        return murmur3_long_plain(values, seed)
    if values.device.type != "cuda":
        raise ValueError(f"murmur3_long: no kernel for {values.device}")
    if not values.is_contiguous() or (per_row and not seed.is_contiguous()):
        raise ValueError("murmur3_long: contiguous tensors expected")
    n = values.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=values.device)
    if n == 0:
        return out
    lib = _lib("murmur3")
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.murmur3_long(values.data_ptr(),
                               seed.data_ptr() if per_row else None,
                               0 if per_row else int(seed) & M32,
                               int(per_row), out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"murmur3_long launch failed: CUDA error {err}")
    LAUNCHES["murmur3_long"] += 1
    return out


# --------------------------------------------------------------------------
# rand()'s draw: numpy's PCG64 stream on the card.  No TPU kernel matches it:
# the JAX package draws on the host (sql/expressions/context_fns.py, Rand)
# --------------------------------------------------------------------------

#: PCG64's LCG multiplier (numpy's PCG_DEFAULT_MULTIPLIER_128)
PCG64_MULT = (0x2360ED051FC65DA4 << 64) | 0x4385DF649FCCF645
_M64 = (1 << 64) - 1
_M128 = (1 << 128) - 1


def pcg64_seeded(seed: int):
    """(state, inc) of numpy's ``PCG64(seed)``: the seed through numpy's
    SeedSequence, as the JAX package seeds each partition's stream."""
    import numpy as np
    st = np.random.PCG64(seed).state["state"]
    return int(st["state"]), int(st["inc"])


def pcg64_jump(steps: int, inc: int):
    """(multiplier, increment) of ``steps`` LCG steps at once:
    state_{k+steps} = mult * state_k + plus (mod 2^128)."""
    acc_mult, acc_plus, mult, plus = 1, 0, PCG64_MULT, inc
    while steps:
        if steps & 1:
            acc_mult = acc_mult * mult & _M128
            acc_plus = (acc_plus * mult + plus) & _M128
        plus = (mult + 1) * plus & _M128
        mult = mult * mult & _M128
        steps >>= 1
    return acc_mult, acc_plus


def pcg64_uniform_plain(state: int, inc: int, offset: int, n: int,
                        device) -> torch.Tensor:
    """float64[n]: numpy's stream itself, ``Generator(PCG64 at (state,
    inc)).advance(offset).random(n)``, on ``device``."""
    import numpy as np
    bg = np.random.PCG64()
    bg.state = {"bit_generator": "PCG64",
                "state": {"state": int(state), "inc": int(inc)},
                "has_uint32": 0, "uinteger": 0}
    bg.advance(int(offset))
    return torch.from_numpy(np.random.Generator(bg).random(int(n))).to(
        device)


@functools.lru_cache(maxsize=None)
def pcg64_tables(threads: int) -> tuple:
    """The jump tables of ``csrc/pcg64.cu``, which no stream changes:
    (M^t, S_t) for each thread offset t in [0, threads], then (M^(2^k),
    S_(2^k)) for each bit k < 64.  Jumping d steps from state s gives
    M^d * s + inc * S_d (mod 2^128), with S_d = sum of M^i for i < d."""
    entries = []
    mult, total = 1, 0
    for _ in range(threads + 1):
        entries.append((mult, total))
        mult, total = mult * PCG64_MULT & _M128, (total + mult) & _M128
    mult, total = PCG64_MULT, 1
    for _ in range(64):
        entries.append((mult, total))
        mult, total = mult * mult & _M128, (mult + 1) * total & _M128
    return tuple(entries)


def _pcg64_device_tables(threads: int, device: torch.device) -> torch.Tensor:
    """:func:`pcg64_tables` on ``device``, uploaded once: each entry as the
    four 64-bit words (M low, M high, S low, S high), the little-endian
    layout of two ``unsigned __int128``."""
    key = (threads, device.index)
    with _LIB_LOCK:
        got = _PCG64_TABLES.get(key)
        if got is None:
            import numpy as np
            words = np.array([w for m, s in pcg64_tables(threads)
                              for w in (m & _M64, m >> 64, s & _M64, s >> 64)],
                             dtype=np.uint64)
            got = torch.from_numpy(words.view(np.int64)).to(device)
            _PCG64_TABLES[key] = got
        return got


def pcg64_launch(lib: ctypes.CDLL, state: int, inc: int, offset: int,
                 out: torch.Tensor) -> int:
    """Launch a build of ``csrc/pcg64.cu`` into the CUDA float64 tensor
    ``out`` (draws ``offset ..`` of the stream at (``state``, ``inc``)) on
    the current stream; returns the CUDA error code.  The host computes what
    depends on the stream: the state at draw ``offset + 1`` and the stride
    jump's increment.  Counts nothing: :func:`pcg64_uniform` does."""
    threads = lib.pcg64_stride()
    tables = _pcg64_device_tables(threads, out.device)
    mult, plus = pcg64_jump(offset + 1, inc)
    start = (mult * state + plus) & _M128
    jump_mult, jump_sum = pcg64_tables(threads)[threads]
    words = [w for v in (start, inc, jump_mult, inc * jump_sum & _M128)
             for w in ((v >> 64) & _M64, v & _M64)]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        return lib.pcg64_uniform(tables.data_ptr(), *words, out.data_ptr(),
                                 out.shape[0], stream)


def pcg64_uniform(state: int, inc: int, offset: int, n: int,
                  device) -> torch.Tensor:
    """float64[n] uniform draws ``offset .. offset + n - 1`` of the PCG64
    stream at (``state``, ``inc``), bit for bit numpy's ``random()`` (see
    ``csrc/pcg64.cu``).  On the CPU, :func:`pcg64_uniform_plain`."""
    device = torch.device(device)
    n, offset = int(n), int(offset)
    if n < 0 or offset < 0:
        raise ValueError(f"pcg64_uniform: n {n} and offset {offset} must "
                         "not be negative")
    if device.type == "cpu":
        return pcg64_uniform_plain(state, inc, offset, n, device)
    if device.type != "cuda":
        raise ValueError(f"pcg64_uniform: no kernel for {device}")
    out = torch.empty(n, dtype=torch.float64, device=device)
    if n == 0:
        return out
    err = pcg64_launch(_lib("pcg64"), int(state), int(inc), offset, out)
    if err != 0:
        raise RuntimeError(f"pcg64_uniform launch failed: CUDA error {err}")
    LAUNCHES["pcg64"] += 1
    return out


def _launch_check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _string_inputs(name: str, chars: torch.Tensor, lens: torch.Tensor):
    if chars.dim() != 2 or chars.dtype != torch.uint8 or lens.dim() != 1 \
            or lens.dtype != torch.int32 or lens.shape[0] != chars.shape[0]:
        raise TypeError(f"{name}: uint8[rows, width] and int32[rows] "
                        "expected, "
                        f"got {chars.dtype}{list(chars.shape)} and "
                        f"{lens.dtype}{list(lens.shape)}")
    if chars.device != lens.device:
        raise ValueError(f"{name}: chars and lengths on different devices")
    if chars.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {chars.device}")


# --------------------------------------------------------------------------
# md5 of each row: no TPU kernel matches it (the JAX package hashes per row on
# the host with hashlib, sql/expressions/strings.py Md5)
# --------------------------------------------------------------------------

_MD5_K = [int(abs(math.sin(i + 1)) * 2 ** 32) & M32 for i in range(64)]
_MD5_S = [7, 12, 17, 22] * 4 + [5, 9, 14, 20] * 4 + [4, 11, 16, 23] * 4 + \
    [6, 10, 15, 21] * 4
_HEX = b"0123456789abcdef"


def md5_plain(chars: torch.Tensor, lens: torch.Tensor,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """uint8[rows, 32]: the lower-case hex MD5 (RFC 1321) of each row's
    bytes, in uint32 words held in int64 and masked to 32 bits, over the
    blocks of the widest row (a shorter row keeps its state past its last
    block); 32 zero bytes for a row that ``valid`` (bool[rows]) marks not
    valid."""
    rows, width = chars.shape
    dev = chars.device
    n = lens.to(torch.int64).clamp(0, width)
    nb = (width + 8) // 64 + 1
    j = torch.arange(nb * 64, device=dev)[None]
    buf = torch.nn.functional.pad(chars.to(torch.int64), (0, nb * 64 - width))
    buf = torch.where(j < n[:, None], buf,
                      torch.where(j == n[:, None], 0x80, 0))
    last = torch.div(n + 8, 64, rounding_mode="floor")
    bits = n * 8
    for b in range(8):
        buf.scatter_(1, (last * 64 + 56 + b)[:, None],
                     ((bits >> (8 * b)) & 0xFF)[:, None])
    by = buf.view(rows, nb * 16, 4)
    words = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) | \
        (by[..., 3] << 24)
    state = [torch.full((rows,), v, dtype=torch.int64, device=dev)
             for v in (0x67452301, 0xefcdab89, 0x98badcfe, 0x10325476)]
    for blk in range(nb):
        m = words[:, blk * 16:(blk + 1) * 16]
        a, b, c, d = state
        for i in range(64):
            if i < 16:
                f, g = (b & c) | ((b ^ M32) & d), i
            elif i < 32:
                f, g = (d & b) | ((d ^ M32) & c), (5 * i + 1) % 16
            elif i < 48:
                f, g = b ^ c ^ d, (3 * i + 5) % 16
            else:
                f, g = c ^ (b | (d ^ M32)), (7 * i) % 16
            t = (a + f + _MD5_K[i] + m[:, g]) & M32
            a, b, c, d = d, (b + rotl32(t, _MD5_S[i])) & M32, b, c
        live = blk <= last
        state = [torch.where(live, (s0 + s1) & M32, s0)
                 for s0, s1 in zip(state, (a, b, c, d))]
    digest = torch.stack([(h >> (8 * k)) & 0xFF for h in state
                          for k in range(4)], dim=1)
    hexd = torch.tensor(list(_HEX), dtype=torch.uint8, device=dev)
    out = torch.stack([hexd[digest >> 4], hexd[digest & 15]],
                      dim=2).reshape(rows, 32)
    return out if valid is None else torch.where(valid[:, None], out, 0)


def md5(chars: torch.Tensor, lens: torch.Tensor,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """The hex MD5 of each row of a string matrix (see ``csrc/md5.cu``);
    a row that ``valid`` (bool[rows], default all) marks not valid is not
    hashed and gives 32 zero bytes.  CPU tensors take :func:`md5_plain`."""
    _string_inputs("md5", chars, lens)
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != lens.shape
                              or valid.device != lens.device):
        raise TypeError(f"md5: valid must be bool{list(lens.shape)} on "
                        f"{lens.device}, got {valid.dtype}"
                        f"{list(valid.shape)} on {valid.device}")
    if chars.device.type == "cpu":
        return md5_plain(chars, lens, valid)
    chars, lens = chars.contiguous(), lens.contiguous()
    valid = None if valid is None else valid.contiguous()
    rows, width = chars.shape
    # a fresh allocation: 16-byte aligned, as md5_rows requires
    out = torch.empty(rows, 32, dtype=torch.uint8, device=chars.device)
    if rows == 0:
        return out
    lib = _lib("md5")
    with torch.cuda.device(chars.device):
        err = lib.md5_rows(chars.data_ptr(), width, lens.data_ptr(),
                           None if valid is None else valid.data_ptr(),
                           out.data_ptr(), rows, _stream(chars.device))
    _launch_check("md5", err)
    LAUNCHES["md5"] += 1
    return out


# --------------------------------------------------------------------------
# the shortest digits of a double or float (Java's Double.toString and
# Float.toString, JDK 19+): no TPU kernel matches it (the JAX package formats
# per row on the host, sql/expressions/cast.py _java_double_str)
# --------------------------------------------------------------------------

#: (Q_MIN, Q_MAX, P) of doubles and floats: c 2^q with c < 2^P
_DTOA_FORMATS = {False: (-1074, 971, 53), True: (-149, 104, 24)}


def flog10pow2(q: int) -> int:
    """floor(log10(2^q)), exact."""
    if q >= 0:
        return len(str(1 << q)) - 1
    return -len(str(1 << -q))     # 2^-q is no power of ten


def flog10_three_quarters_pow2(q: int) -> int:
    """floor(log10(3/4 2^q)), exact."""
    num, den = (3 << q, 4) if q >= 0 else (3, 4 << -q)
    k = flog10pow2(q)
    while (num * 10 ** -k if k < 0 else num) < (den * 10 ** k if k >= 0
                                                 else den):
        k -= 1
    return k


def flog2pow10(e: int) -> int:
    """floor(log2(10^e)), exact."""
    if e >= 0:
        return (10 ** e).bit_length() - 1
    return -((10 ** -e - 1).bit_length())


@functools.lru_cache(maxsize=None)
def dtoa_tables(is_float: bool) -> dict:
    """The tables of ``csrc/dtoa.cu`` from Python's exact integers: ``kq``
    [2][Q_MAX - Q_MIN + 1] (k for each q at the regular spacing, then where
    the spacing below is half), ``f2`` [nk] (floor(log2 10^-k) from
    ``k_min``), ``g``: for doubles (g1, g0) with g = g1 2^63 + g0 =
    floor(10^-k 2^(125 - f2)) + 1, for floats g1 + 1; and ``c_tiny``, the
    subnormals below which the value is scaled by ten (so that its
    candidates have two digits)."""
    q_min, q_max, _ = _DTOA_FORMATS[is_float]
    qs = range(q_min, q_max + 1)
    kq = [[flog10pow2(q) for q in qs],
          [flog10_three_quarters_pow2(q) for q in qs]]
    k_min = min(min(r) for r in kq)
    k_max = max(max(r) for r in kq)
    f2, g = [], []
    for k in range(k_min, k_max + 1):
        f = flog2pow10(-k)
        num, den = (10 ** -k, 1) if k <= 0 else (1, 10 ** k)
        shift = 125 - f
        num, den = (num << shift, den) if shift >= 0 else (num, den << -shift)
        g126 = num // den + 1
        f2.append(f)
        if is_float:
            g.append((g126 >> 63) + 1)
        else:
            g.append((g126 >> 63, g126 & ((1 << 63) - 1)))
    if max(x for v in g for x in (v if isinstance(v, tuple) else (v,))) \
            >= 1 << 63:
        raise AssertionError("a dtoa multiplier does not fit 63 bits")
    k = flog10pow2(q_min)
    c_tiny = -(-(1 << -q_min) // 10 ** -(k + 1))
    return dict(kq=kq, f2=f2, g=g, k_min=k_min, nq=len(qs), c_tiny=c_tiny,
                q_min=q_min)


def _dtoa_device_tables(is_float: bool, device: torch.device):
    """:func:`dtoa_tables` on ``device`` as (kq, f2, g) tensors, uploaded
    once per device."""
    key = (is_float, str(device))
    with _LIB_LOCK:
        got = _DTOA_TABLES.get(key)
        if got is None:
            t = dtoa_tables(is_float)
            got = (torch.tensor(t["kq"], dtype=torch.int32).to(device),
                   torch.tensor(t["f2"], dtype=torch.int32).to(device),
                   torch.tensor(t["g"], dtype=torch.int64).to(device))
            _DTOA_TABLES[key] = got
        return got


# 64 x 128-bit products in torch: unsigned values as 21-bit limbs in int64
# (a limb product is 42 bits; a column of them stays far below 2^63)
_LB = 21
_LMASK = (1 << _LB) - 1


def _limbs(x: torch.Tensor, n: int = 3) -> list:
    return [(x >> (_LB * i)) & _LMASK for i in range(n)]


def _carry(cols: list) -> list:
    out, carry = [], 0
    for c in cols:
        c = c + carry
        out.append(c & _LMASK)
        carry = c >> _LB
    return out + [carry]


def _mul_limbs(a: list, b: list, n: int | None = None) -> list:
    """The product's limbs; with ``n`` only its low ``n`` columns (the
    product mod 2^(21 n), and a carry limb)."""
    cols = [0] * (len(a) + len(b) if n is None else n)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            if i + j < len(cols):
                cols[i + j] = cols[i + j] + ai * bj
    return _carry(cols)


def _shr_limbs(a: list, s: int) -> list:
    q, r = divmod(s, _LB)
    a = a[q:]
    if not r:
        return a
    return [(x >> r) | ((a[i + 1] << (_LB - r)) & _LMASK if i + 1 < len(a)
                        else 0) for i, x in enumerate(a)]


def _add_limbs(a: list, b: list) -> list:
    n = max(len(a), len(b))
    a, b = a + [0] * (n - len(a)), b + [0] * (n - len(b))
    return _carry([x + y for x, y in zip(a, b)])


def _limbs_value(a: list) -> torch.Tensor:
    """The value of limbs known to be below 2^63."""
    v = a[0]
    for i in range(1, min(len(a), -(-63 // _LB))):
        v = v | (a[i] << (_LB * i))
    return v


def _rop_f64(g1, g0, cp):
    """DoubleToDecimal.rop: with A = g1 cp and B = g0 cp, W = (A >> 1) +
    (B >> 64) and vb = (W >> 63) | (W mod 2^63 != 0)."""
    c = _limbs(cp)
    w = _add_limbs(_shr_limbs(_mul_limbs(_limbs(g1), c), 1),
                   _shr_limbs(_mul_limbs(_limbs(g0), c), 64))
    sticky = (w[0] | w[1] | w[2]) != 0
    return _limbs_value(w[3:6]) | sticky.to(torch.int64)


def _const_limbs(c: int, n: int = 4) -> list:
    """A Python integer below 2^(21 n) as limbs."""
    return [(c >> (_LB * i)) & _LMASK for i in range(n)]


#: 5^-1 mod 2^64, which is also ceil(2^67 / 10)
_INV5 = 0xcccccccccccccccd


def _div10(s: torch.Tensor) -> torch.Tensor:
    """s // 10 for 0 <= s < 2^63 as the kernel takes it: the high word of
    s * ceil(2^67 / 10), shifted right by 3 (bits 67 and up)."""
    return _limbs_value(_shr_limbs(_mul_limbs(_limbs(s),
                                              _const_limbs(_INV5)), 67))


def _strip_test(d: torch.Tensor, k: int, small):
    """(10^k divides d, d / 10^k) by the kernel's test, in 32-bit words
    where ``small`` (d < 2^32 there) and in 64-bit words elsewhere: x = d
    5^-k mod 2^bits, q = x rotated right by k, divisible when q <= (2^bits
    - 1) / 10^k.  x comes from 21-bit limbs (the low 84 bits of the
    product), and the test reads the rotation's two parts: a bit rotated
    in from x's low k bits would put q at or above 2^(bits - k), past the
    limit, so q <= limit is those bits zero and x >> k <= limit."""
    inv64 = pow(5, -k, 1 << 64)
    inv = [torch.where(small, a, b) for a, b in
           zip(_const_limbs(inv64 & 0xffffffff), _const_limbs(inv64))]
    x = _mul_limbs(_limbs(d), inv, 4)[:4]
    mask = torch.where(small, (1 << (32 - k)) - 1, (1 << (64 - k)) - 1)
    lim = torch.where(small, 0xffffffff // 10 ** k, ((1 << 64) - 1) // 10 ** k)
    q = _limbs_value(_shr_limbs(x, k)) & mask
    return ((x[0] & ((1 << k) - 1)) == 0) & (q <= lim), q


def strip_zeros_plain(d: torch.Tensor, e: torch.Tensor):
    """(d without its trailing zeros, e plus their count) for int64 digits
    0 <= d < 2^63, in the steps of ``csrc/dtoa.cu``: 10^8 in 64-bit words,
    then 10^8, 10^4, 10^2 and 10 in 32-bit words where what is left is
    below 2^32, else in 64 (:func:`_strip_test`); each step taken where it
    holds.  d = 0 stays."""
    nz = d != 0
    small = torch.zeros_like(nz)
    for i, k in enumerate((8, 8, 4, 2, 1)):
        ok, q = _strip_test(d, k, small)
        ok = nz & ok
        d = torch.where(ok, q, d)
        e = e + torch.where(ok, k, 0).to(e.dtype)
        if i == 0:  # the word size of the four steps left
            small = d <= 0xffffffff
    return d, e


def _rop_f32(g, cp):
    """FloatToDecimal.rop: x1 = (g cp) >> 64, vb = (x1 >> 31) | (x1 mod 2^32
    != 0)."""
    x1 = _limbs_value(_shr_limbs(_mul_limbs(_limbs(g), _limbs(cp)), 64)[:3])
    return (x1 >> 31) | ((x1 & M32) != 0).to(torch.int64)


def dtoa_plain(values: torch.Tensor):
    """(int64 digits, int32 exponents, int8 sides) of each double or float:
    the arithmetic of ``csrc/dtoa.cu`` in torch ops, every branch for every
    row, chosen with masks."""
    is_float = values.dtype == torch.float32
    t = dtoa_tables(is_float)
    kq, f2, g = _dtoa_device_tables(is_float, values.device)
    q_min, _, p = _DTOA_FORMATS[is_float]
    ebits = 8 if is_float else 11
    bits = (values.view(torch.int32).to(torch.int64) & M32) if is_float \
        else values.view(torch.int64)
    bq = (bits >> (p - 1)) & ((1 << ebits) - 1)
    tm = bits & ((1 << (p - 1)) - 1)
    c_min = 1 << (p - 1)
    special = (bq == (1 << ebits) - 1) | ((bq == 0) & (tm == 0))
    normal = bq != 0
    bias = (1 << (ebits - 1)) - 1 + p - 1     # 1075, 150
    mq = bias - bq
    q = torch.where(normal, -mq, q_min)
    c = torch.where(normal, tm | c_min, tm)
    sh = mq.clamp(0, 62)
    fast = normal & (mq > 0) & (mq < p) & (((c >> sh) << sh) == c)
    tiny = ~normal & (tm < t["c_tiny"])
    c = torch.where(tiny, 10 * tm, c)
    dk = torch.where(tiny, -1, 0)
    out = c & 1
    cb = c << 2
    regular = (c != c_min) | (q == q_min)
    cbl = torch.where(regular, cb - 2, cb - 1)
    cbr = cb + 2
    qi = (q - q_min).clamp(0, t["nq"] - 1)
    k = torch.where(regular, kq[0][qi], kq[1][qi]).to(torch.int64)
    ki = (k - t["k_min"]).clamp(0, f2.shape[0] - 1)
    h = (q + f2[ki] + (33 if is_float else 2)).clamp(0, 40)
    if is_float:
        gk = g[ki]
        vb, vbl, vbr = (_rop_f32(gk, x << h) for x in (cb, cbl, cbr))
    else:
        g1, g0 = g[ki, 0], g[ki, 1]
        vb, vbl, vbr = (_rop_f64(g1, g0, x << h) for x in (cb, cbl, cbr))
    s = vb >> 2
    sp10 = 10 * _div10(s)
    tp10 = sp10 + 10
    upin = vbl + out <= (sp10 << 2)
    wpin = (tp10 << 2) + out <= vbr
    short = (s >= 100) & (upin != wpin)
    s1 = s + 1
    uin = vbl + out <= (s << 2)
    win = (s1 << 2) + out <= vbr
    cmp = vb - ((s + s1) << 1)
    closer = torch.where((cmp < 0) | ((cmp == 0) & ((s & 1) == 0)), s, s1)
    d = torch.where(short, torch.where(upin, sp10, tp10),
                    torch.where(uin != win, torch.where(uin, s, s1), closer))
    e = torch.where(short, k, k + dk)
    side = torch.sign((d << 2) - vb)
    d = torch.where(fast, c >> sh, d)
    e = torch.where(fast, 0, e)
    side = torch.where(fast, 0, side)
    d = torch.where(special, 0, d)
    e = torch.where(special, 0, e)
    side = torch.where(special, 0, side)
    d, e = strip_zeros_plain(d, e)
    return d, e.to(torch.int32), side.to(torch.int8)


def dtoa_shortest(values: torch.Tensor):
    """(int64 digits without trailing zeros, int32 exponents, int8 sides)
    of each float64 or float32: value = digits 10^exponent, the shortest
    decimal that reads back to it as Java 19+ chooses it; the side of the
    digits against the value (-1 below, 0 equal, 1 above); digits 0 for NaN,
    the infinities and the zeros (see ``csrc/dtoa.cu``).  CPU tensors take
    :func:`dtoa_plain`."""
    if values.dim() != 1 or values.dtype not in (torch.float64,
                                                 torch.float32):
        raise TypeError(f"dtoa_shortest: float64[n] or float32[n] expected, "
                        f"got {values.dtype}{list(values.shape)}")
    if values.device.type == "cpu":
        return dtoa_plain(values.contiguous())
    if values.device.type != "cuda":
        raise ValueError(f"dtoa_shortest: no kernel for {values.device}")
    values = values.contiguous()
    n = values.shape[0]
    dev = values.device
    digits = torch.empty(n, dtype=torch.int64, device=dev)
    exps = torch.empty(n, dtype=torch.int32, device=dev)
    sides = torch.empty(n, dtype=torch.int8, device=dev)
    if n == 0:
        return digits, exps, sides
    is_float = values.dtype == torch.float32
    t = dtoa_tables(is_float)
    kq, f2, g = _dtoa_device_tables(is_float, dev)
    lib = _lib("dtoa")
    with torch.cuda.device(dev):
        err = lib.dtoa_shortest(values.data_ptr(), int(is_float), n,
                                kq.data_ptr(), f2.data_ptr(), g.data_ptr(),
                                t["nq"], t["k_min"], t["c_tiny"],
                                digits.data_ptr(), exps.data_ptr(),
                                sides.data_ptr(), _stream(dev))
    _launch_check("dtoa_shortest", err)
    LAUNCHES["dtoa_shortest"] += 1
    return digits, exps, sides


# --------------------------------------------------------------------------
# the regexp functions' DFA walk: no Pallas kernel (the JAX package scans the
# byte axis with lax.scan, ops/regex_engine.py dfa_search :625 and
# dfa_match_spans :659)
# --------------------------------------------------------------------------

def dfa_fused(table: torch.Tensor, cls: torch.Tensor,
              accept: torch.Tensor) -> torch.Tensor:
    """The search kernel's table, int16 [states, 256] (uint16 bits): for
    each state and byte, the next state ``table[state, cls[byte]]`` and its
    accept flag, ``next | accept[next] << 8``."""
    nxt = table.long()[:, cls.long()]
    return (nxt | (accept.long()[nxt] << 8)).to(torch.int16).contiguous()


def dfa_tables(rx, device) -> dict:
    """A compiled regex (``ops/regex_engine.CompiledRegex``) as the kernels
    take it on ``device``: the next-state table uint8 [states, classes], the
    byte classes uint8 [256], the accept flags uint8 [states], the search
    kernel's fused table (:func:`dfa_fused`), and its start and dead states
    and anchors.  Built once per regex and device."""
    cache = rx.__dict__.setdefault("_device_tables", {})
    key = str(torch.device(device))
    got = cache.get(key)
    if got is None:
        import numpy as np
        states, classes = rx.table.shape
        if states > 256 or int(rx.byte_class.max()) >= 256:
            raise ValueError(f"a DFA of {states} states and "
                             f"{classes} classes does not fit uint8 entries")
        table = torch.from_numpy(rx.table.astype(np.uint8)).to(device)
        cls = torch.from_numpy(rx.byte_class.astype(np.uint8)).to(device)
        accept = torch.from_numpy(rx.accept.astype(np.uint8)).to(device)
        got = dict(
            table=table, cls=cls, accept=accept,
            fused=dfa_fused(table, cls, accept),
            states=states, classes=classes, start=int(rx.start),
            dead=int(rx.dead), anchored_start=bool(rx.anchored_start),
            anchored_end=bool(rx.anchored_end))
        cache[key] = got
    return got


def _dfa_parts(dfa: dict, chars: torch.Tensor):
    cls = dfa["cls"].to(torch.int64)[chars.to(torch.int64)]
    return cls, dfa["table"].to(torch.int64), dfa["accept"].to(torch.bool)


def dfa_search_plain(dfa: dict, chars: torch.Tensor,
                     lens: torch.Tensor) -> torch.Tensor:
    """bool per row: the DFA accepts after some prefix (at the row's end
    only, for a pattern anchored at its end); the JAX ``dfa_search`` loop
    over the byte columns."""
    rows, width = chars.shape
    cls, table, accept = _dfa_parts(dfa, chars)
    state = torch.full((rows,), dfa["start"], dtype=torch.int64,
                       device=chars.device)
    hit = accept[state]
    if dfa["anchored_end"]:
        hit = hit & (lens == 0)
    for j in range(width):
        live = j < lens
        state = torch.where(live, table[state, cls[:, j]], state)
        acc = accept[state] & live
        if dfa["anchored_end"]:
            acc = acc & (lens - 1 == j)
        hit = hit | acc
    return hit


def dfa_match_spans_plain(dfa: dict, chars: torch.Tensor,
                          lens: torch.Tensor):
    """(bool chosen [rows, width + 1], int32 mlen [rows, width + 1]): the
    JAX ``dfa_match_spans``: the DFA from every start at once, the longest
    accepting end of each, then the leftmost non-overlapping matches, the
    next start at p + max(mlen, 1)."""
    rows, width = chars.shape
    dev = chars.device
    cls, table, accept = _dfa_parts(dfa, chars)
    ns = width + 1
    lens64 = lens.to(torch.int64)[:, None]
    starts = torch.arange(ns, device=dev)[None]
    state = torch.full((rows, ns), dfa["start"], dtype=torch.int64,
                       device=dev)
    empty = bool(accept[dfa["start"]])
    best = torch.where(empty & (starts <= lens64), starts, -1).expand(
        rows, ns)
    for j in range(width):
        active = (starts <= j) & (j < lens64)
        state = torch.where(active, table[state, cls[:, j:j + 1]], state)
        best = torch.where(accept[state] & active, j + 1, best)
    if dfa["anchored_start"]:
        best = torch.where(starts == 0, best, -1)
    if dfa["anchored_end"]:
        best = torch.where((best == lens64) & (best >= 0), best, -1)
    mlen = torch.where(best >= 0, best - starts, -1)
    next_free = torch.zeros(rows, dtype=torch.int64, device=dev)
    chosen, out = [], []
    for p in range(ns):
        m = mlen[:, p]
        can = (next_free <= p) & (m >= 0) & (p <= lens64[:, 0])
        next_free = torch.maximum(next_free, torch.where(
            can, p + m.clamp(min=1), next_free))
        chosen.append(can)
        out.append(torch.where(can, m, 0))
    return torch.stack(chosen, 1), torch.stack(out, 1).to(torch.int32)


def dfa_search(dfa: dict, chars: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """bool per row: the regex matches somewhere in the row (see
    ``csrc/regex_dfa.cu``); ``dfa`` from :func:`dfa_tables` of a pattern
    compiled with its search prefix (a hand-made ``dfa`` carries its
    :func:`dfa_fused` table too).  CPU tensors take
    :func:`dfa_search_plain`."""
    _string_inputs("dfa_search", chars, lens)
    if chars.device.type == "cpu":
        return dfa_search_plain(dfa, chars, lens)
    chars, lens = chars.contiguous(), lens.contiguous()
    rows, width = chars.shape
    hit = torch.empty(rows, dtype=torch.bool, device=chars.device)
    if rows == 0:
        return hit
    lib = _lib("regex_dfa")
    with torch.cuda.device(chars.device):
        err = lib.dfa_search(
            chars.data_ptr(), width, lens.data_ptr(), dfa["fused"].data_ptr(),
            dfa["accept"].data_ptr(), dfa["states"], dfa["start"],
            dfa["dead"], int(dfa["anchored_end"]), hit.data_ptr(), rows,
            _stream(chars.device))
    _launch_check("dfa_search", err)
    LAUNCHES["dfa_search"] += 1
    return hit


def dfa_spans_path(dfa: dict, width: int) -> int:
    """The path the span kernel takes for rows of ``width`` bytes (0 the
    shared-memory tile, 1 a warp a row; ``csrc/regex_dfa.cu``).  Builds the
    kernel: on the card's machine only."""
    return _lib("regex_dfa").dfa_spans_path(width, dfa["states"],
                                            dfa["classes"])


def dfa_match_spans(dfa: dict, chars: torch.Tensor, lens: torch.Tensor):
    """(bool chosen, int32 mlen), each [rows, width + 1]: the leftmost-
    longest non-overlapping matches of the regex (see
    ``csrc/regex_dfa.cu``).  CPU tensors take
    :func:`dfa_match_spans_plain`."""
    _string_inputs("dfa_match_spans", chars, lens)
    if chars.device.type == "cpu":
        return dfa_match_spans_plain(dfa, chars, lens)
    rows, width = chars.shape
    # the kernel writes every position
    chosen = torch.empty(rows, width + 1, dtype=torch.bool,
                         device=chars.device)
    mlen = torch.empty(rows, width + 1, dtype=torch.int32,
                       device=chars.device)
    if rows == 0:
        return chosen, mlen
    chars, lens = chars.contiguous(), lens.contiguous()
    lib = _lib("regex_dfa")
    with torch.cuda.device(chars.device):
        err = lib.dfa_match_spans(
            chars.data_ptr(), width, lens.data_ptr(), dfa["table"].data_ptr(),
            dfa["cls"].data_ptr(), dfa["accept"].data_ptr(), dfa["states"],
            dfa["classes"], dfa["start"], dfa["dead"],
            int(dfa["anchored_start"]), int(dfa["anchored_end"]),
            chosen.data_ptr(), mlen.data_ptr(), rows, _stream(chars.device))
    _launch_check("dfa_match_spans", err)
    LAUNCHES["dfa_match_spans"] += 1
    return chosen, mlen
