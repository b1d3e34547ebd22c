"""The port's segmented-sum kernel module (spark_rapids_tpu_torch/ops/
kernels.py) held against what it replaces in the JAX package: seg_sum_f32
against the TPU kernel seg_sum_f32_pallas, run in interpret mode as
tests/test_native.py runs it, and seg_sum_f64 against the XLA scatter
seg_sum2 that takes the double sums there.

The tests hand the wrapper CPU tensors, so it takes the plain PyTorch version;
the CUDA kernel itself is compared with that plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import segmented as JS
from spark_rapids_tpu.ops.pallas_kernels import seg_sum_f32_pallas
from spark_rapids_tpu_torch.ops import kernels as K

N = 3000


def _inputs(rng, s, out_size, flags):
    vals = (rng.random((s, N)) < 0.5) if flags else rng.random((s, N))
    vals = vals.astype(np.float32)
    # dead ranks on both sides of the table
    rank = rng.integers(-3, out_size + 4, N).astype(np.int32)
    return vals, rank


def _numpy_sum(vals, rank, out_size):
    exp = np.zeros((vals.shape[0], out_size), np.float64)
    live = (rank >= 0) & (rank < out_size)
    for i in range(vals.shape[0]):
        np.add.at(exp[i], rank[live], vals[i][live].astype(np.float64))
    return exp


def _pallas(vals, rank, out_size):
    # the JAX package feeds ranks >= 0 (dead rows sit at cap - 1); map the
    # negative dead ranks above the table for it
    r = np.where(rank < 0, out_size + 1, rank).astype(np.int32)
    return np.asarray(seg_sum_f32_pallas(jnp.asarray(vals), jnp.asarray(r),
                                         out_size, interpret=True))


@pytest.mark.parametrize("s", [1, 3, 11])
@pytest.mark.parametrize("out_size", [1, 6, 256])
def test_plain_seg_sum_matches_pallas_on_flags_exactly(rng, s, out_size):
    vals, rank = _inputs(rng, s, out_size, flags=True)
    got = K.seg_sum_f32(torch.from_numpy(vals), torch.from_numpy(rank),
                        out_size).numpy()
    assert got.shape == (s, out_size) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _pallas(vals, rank, out_size))
    np.testing.assert_array_equal(got, _numpy_sum(vals, rank, out_size))


@pytest.mark.parametrize("s", [1, 11])
def test_plain_seg_sum_matches_pallas_on_random_f32(rng, s):
    vals, rank = _inputs(rng, s, 6, flags=False)
    got = K.seg_sum_f32_plain(torch.from_numpy(vals), torch.from_numpy(rank),
                              6).numpy()
    # f32 sums of <= 3000 terms in two orders
    np.testing.assert_allclose(got, _pallas(vals, rank, 6), rtol=1e-4)
    np.testing.assert_allclose(got, _numpy_sum(vals, rank, 6), rtol=1e-4)


def _seg_sum2(vals, rank, out_size):
    """The JAX package's double-sum path: seg_sum2 over the [n, s] slot
    matrix (jnp on the CPU), transposed to the kernel's [s, out_size]."""
    return np.asarray(JS.seg_sum2(jnp, jnp.asarray(vals.T),
                                  jnp.asarray(rank), out_size)).T


@pytest.mark.parametrize("s", [1, 7])
@pytest.mark.parametrize("out_size", [1, 6, 256])
@pytest.mark.parametrize("integers", [False, True])
def test_plain_seg_sum_f64_matches_seg_sum2_and_numpy(rng, s, out_size,
                                                      integers):
    vals = rng.integers(-1000, 1001, (s, N)) if integers \
        else rng.standard_normal((s, N)) * 1e3
    vals = vals.astype(np.float64)
    # dead ranks on both sides of the table
    rank = rng.integers(-3, out_size + 4, N).astype(np.int32)
    got = K.seg_sum_f64(torch.from_numpy(vals), torch.from_numpy(rank),
                        out_size).numpy()
    assert got.shape == (s, out_size) and got.dtype == np.float64
    want = _numpy_sum(vals, rank, out_size)
    if integers:    # integer-valued doubles far below 2^53: exact
        np.testing.assert_array_equal(got, _seg_sum2(vals, rank, out_size))
        np.testing.assert_array_equal(got, want)
    else:           # f64 sums of <= 3000 terms in other orders
        np.testing.assert_allclose(got, _seg_sum2(vals, rank, out_size),
                                   rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_all_dead_ranks_sum_to_zero(rng):
    vals = np.ones((3, 500), np.float32)
    rank = np.full(500, 9, np.int32)
    got = K.seg_sum_f32(torch.from_numpy(vals), torch.from_numpy(rank), 4)
    assert torch.equal(got, torch.zeros(3, 4))
    np.testing.assert_array_equal(_pallas(vals, rank, 4), np.zeros((3, 4)))
    rank[::2] = -1      # negative ranks are dead too
    got = K.seg_sum_f64(torch.from_numpy(vals.astype(np.float64)),
                        torch.from_numpy(rank), 4)
    assert torch.equal(got, torch.zeros(3, 4, dtype=torch.float64))
    np.testing.assert_array_equal(
        _seg_sum2(vals.astype(np.float64), rank, 4), np.zeros((3, 4)))


def test_wrapper_on_cpu_takes_plain_version_and_counts_no_launch(rng):
    K.reset_launches()
    vals, rank = _inputs(rng, 4, 6, flags=True)
    v, r = torch.from_numpy(vals), torch.from_numpy(rank)
    assert torch.equal(K.seg_sum_f32(v, r, 6), K.seg_sum_f32_plain(v, r, 6))
    d = v.double() * 3.5
    assert torch.equal(K.seg_sum_f64(d, r, 6), K.seg_sum_f64_plain(d, r, 6))
    assert K.LAUNCHES == {"seg_sum_f32": 0, "seg_sum_f64": 0,
                          "murmur3_long": 0}


@pytest.mark.parametrize("bad", [
    dict(values=torch.ones(2, 5, dtype=torch.float64)),
    dict(rank=torch.zeros(5, dtype=torch.int64)),
    dict(rank=torch.zeros(4, dtype=torch.int32)),
    dict(values=torch.ones(5)),
    dict(out_size=0),
    dict(out_size=K.SEG_SUM_MAX_GROUPS + 1),
    # the float64 build takes float64 values only, with the same checks
    dict(kernel=K.seg_sum_f64),
    dict(kernel=K.seg_sum_f64, values=torch.ones(2, 5, dtype=torch.float64),
         rank=torch.zeros(5, dtype=torch.int64)),
    dict(kernel=K.seg_sum_f64, values=torch.ones(2, 4, dtype=torch.float64)),
    dict(kernel=K.seg_sum_f64, values=torch.ones(5, dtype=torch.float64)),
    dict(kernel=K.seg_sum_f64, values=torch.ones(2, 5, dtype=torch.float64),
         out_size=K.SEG_SUM_MAX_GROUPS + 1),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = dict(kernel=K.seg_sum_f32, values=torch.ones(2, 5),
                rank=torch.zeros(5, dtype=torch.int32), out_size=3)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        args["kernel"](args["values"], args["rank"], args["out_size"])


def test_kernel_source_and_build_flags_target_hopper():
    src = (K.CSRC / "seg_sum.cu").read_text()
    assert "seg_sum_f32_pallas" in src          # names the TPU kernel
    assert "seg_sum2" in src                    # and what the f64 build takes
    assert 'extern "C"' in src
    for entry in ("seg_sum_f32", "seg_sum_f64"):
        assert f"int {entry}(" in src and f"long long {entry}_scratch(" in src
    assert "arch=compute_90a,code=sm_90a" in K.NVCC_FLAGS
    assert "-Xptxas" in K.NVCC_FLAGS            # spill report of every build
    assert K.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(K.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build("seg_sum")
    assert not (tmp_path / "build").exists()
