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
LAUNCHES = {"seg_sum_f32": 0, "seg_sum_f64": 0, "murmur3_long": 0}

#: the largest group table the segmented-sum kernel takes (the aggregate's
#: small-table limit, ``_MATMUL_MAX_GROUPS`` in the JAX package)
SEG_SUM_MAX_GROUPS = 256

_LIBS: dict = {}
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
