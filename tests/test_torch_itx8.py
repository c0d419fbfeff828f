"""The port's 8x8 DCT_DCT batch against the JAX package's, exactly.

- idct8x8_batch_plain (rav1d_tpu_torch/ops/itx8.py, the CPU side of the
  kernel's wrapper) against idct8x8_batch_jnp and the Pallas kernel
  idct8x8_batch_pallas in interpret mode (as tests/test_pallas_itx8.py
  runs it on the CPU), N=256, bpc 8/10/12;
- against the scalar reference ops.ref.itx.compute_residual_batch, N=128;
- the CUDA source's 8x8 block functions, compiled for the host with g++
  (rav1d_idct8x8_host), against the plain version (the kernel itself
  builds and runs only on the card, where chip_smoke.py holds it to the
  plain version);
- the wrapper's contract: N must be a multiple of 128.

Inputs come from numpy seeds; 1/8 of the blocks are full-range int32 (the
int32 wrap of the multiplies matters there). Tolerance: exact.
"""

import ctypes
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1d_tpu.ops.pallas.itx8 import idct8x8_batch_jnp, idct8x8_batch_pallas
from rav1d_tpu_torch.ops import itx8

CSRC = os.path.join(os.path.dirname(itx8.__file__), "..", "csrc")


def _inputs(bpc, n, seed):
    rng = np.random.default_rng(seed)
    cmax = (1 << (bpc + 7)) - 1
    cb = rng.integers(-cmax, cmax, size=(n, 8, 8), dtype=np.int64)
    cb[: n // 8] = rng.integers(-(2**31), 2**31 - 1, size=(n // 8, 8, 8))
    return cb.astype(np.int32)


@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_plain_matches_jax(bpc):
    cb = _inputs(bpc, 256, 40 + bpc)
    got = itx8.idct8x8_batch_plain(torch.from_numpy(cb), bpc).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(idct8x8_batch_jnp(jnp.asarray(cb), bpc)))
    np.testing.assert_array_equal(
        got, np.asarray(idct8x8_batch_pallas(jnp.asarray(cb), bpc)))
    # on a CPU tensor the wrapper runs the plain version
    np.testing.assert_array_equal(
        itx8.idct8x8_batch(torch.from_numpy(cb), bpc).numpy(), got)


def test_plain_matches_scalar_reference():
    from rav1d_tpu.ops.ref.itx import DCT_DCT, compute_residual_batch

    rng = np.random.default_rng(7)
    cb = rng.integers(-2048, 2048, (128, 8, 8)).astype(np.int64)
    got = itx8.idct8x8_batch_plain(torch.from_numpy(cb.astype(np.int32)))
    # store layout "rc": coeff[y + x*sh] -> pass coefficients transposed
    cf = cb.transpose(0, 2, 1).reshape(128, 64)
    eobs = np.full(128, 63, np.int64)  # full blocks: no dc-only shortcut
    exp = compute_residual_batch(cf, eobs, 8, 8, DCT_DCT, 8)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("itx8") / "libitx_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", so, os.path.join(CSRC, "itx.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    P = ctypes.c_void_p
    lib.rav1d_idct8x8_host.argtypes = [P, P, ctypes.c_int, ctypes.c_int]
    lib.rav1d_idct8x8_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_kernel_source_matches_plain_on_host(host_lib, bpc):
    cb = _inputs(bpc, 1024, 90 + bpc)
    out = np.zeros_like(cb)
    rc = host_lib.rav1d_idct8x8_host(cb.ctypes.data, out.ctypes.data,
                                     cb.shape[0], bpc)
    assert rc == 0
    ref = itx8.idct8x8_batch_plain(torch.from_numpy(cb), bpc).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("n", [100, 129, 200])
def test_batch_not_multiple_of_128_raises(n):
    with pytest.raises(ValueError, match="multiple of 128"):
        itx8.idct8x8_batch(torch.zeros((n, 8, 8), dtype=torch.int32))
