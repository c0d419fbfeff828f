"""The port's inverse transforms against the JAX engine's, exactly.

- the plain torch twin (rav1d_tpu_torch engine/kernels.itx_any_core, the
  CPU side of the itx kernel's wrapper) against rav1d_tpu engine/kernels
  itx_any_core for all 19 tx sizes x bpc 8, 10, 12;
- the twin against the Pallas kernel itx_pallas_core in interpret mode
  for the classes tests/test_pallas_itx_all.py runs on the CPU;
- WHT against wht_core;
- the CUDA source compiled for the host with g++ (its host entry walks the
  kernel's class table with the kernel's own step functions, thread by
  thread) against the twin, for all 19 sizes and the WHT, through the
  per-size entry point's one-class table (the kernel itself builds and
  runs only on the card, where chip_smoke.py holds it to the twin);
- the generated butterfly header against its generator.

tests/test_torch_resid_kernel.py holds the host build's frame entry to
the plain resid program on packed blobs.

Inputs come from numpy seeds and include extreme coefficients (the int32
wrap of the multiplies matters there). Tolerance: exact; integer code has
no rounding slack.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from rav1d_tpu.engine.kernels import itx_any_core as jax_itx_any_core
from rav1d_tpu.engine.kernels import wht_core as jax_wht_core
from rav1d_tpu.ops.ref.itx import _SHIFTS
from rav1d_tpu_torch.engine import kernels as TK
from rav1d_tpu_torch.ops.cuda import gen_itx_1d
from rav1d_tpu_torch.ops.cuda import itx as cuda_itx

SIZES = sorted(_SHIFTS)
CSRC = os.path.join(os.path.dirname(gen_itx_1d.__file__), "..", "..", "csrc")


def _inputs(w, h, bpc, n, seed):
    rng = np.random.default_rng(seed)
    sh, sw = min(h, 32), min(w, 32)
    cmax = (1 << (bpc + 7)) - 1
    cb = rng.integers(-cmax, cmax, size=(n, sh, sw), dtype=np.int32)
    # extreme coefficients: a slice of full-range int32 values
    ext = rng.integers(-(2**31), 2**31 - 1, size=(n // 8, sh, sw),
                       dtype=np.int64).astype(np.int32)
    cb[: n // 8] = ext
    nv_w = 4 if w <= 16 else (2 if w == 32 else 1)
    nv_h = 4 if h <= 16 else (2 if h == 32 else 1)
    f = rng.integers(0, nv_w, size=n).astype(np.int32)
    s = rng.integers(0, nv_h, size=n).astype(np.int32)
    # codes the size does not allow select the dct, as in the JAX engine
    f[-3:] = 5
    return cb, f, s


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("wh", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_twin_matches_jax(wh, bpc):
    w, h = wh
    n = 160  # not a multiple of 128: a partial lane block
    cb, f, s = _inputs(w, h, bpc, n, w * 1000 + h * 10 + bpc)
    ref = np.asarray(jax_itx_any_core(cb, f, s, w, h, bpc))
    got = TK.itx_any_core(torch.from_numpy(cb), torch.from_numpy(f),
                          torch.from_numpy(s), w, h, bpc).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("wh", [(4, 4), (8, 4), (4, 8), (8, 8)],
                         ids=["4x4", "8x4", "4x8", "8x8"])
def test_twin_matches_pallas_interpret(wh):
    from rav1d_tpu.ops.pallas.itx_all import itx_pallas_core

    w, h = wh
    bpc = 8
    cb, f, s = _inputs(w, h, bpc, 160, 77 + w * h)
    f[-3:] = 0
    ref = np.asarray(itx_pallas_core(cb, f, s, w, h, bpc))
    got = cuda_itx.itx(torch.from_numpy(cb), torch.from_numpy(f),
                       torch.from_numpy(s), w, h, bpc).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wht_matches_jax():
    rng = np.random.default_rng(5)
    cb = rng.integers(-(1 << 15), 1 << 15, size=(300, 4, 4), dtype=np.int32)
    ref = np.asarray(jax_wht_core(cb))
    got = TK.wht_core(torch.from_numpy(cb)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_generated_header_is_current():
    with open(os.path.join(CSRC, "itx_1d.cuh")) as fh:
        assert fh.read() == gen_itx_1d.generate()


def build_host_itx(tmp_dir):
    """Compile csrc/itx.cu for the host with g++ and load it."""
    so = os.path.join(str(tmp_dir), "libitx_host.so")
    src = os.path.join(CSRC, "itx.cu")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    P = ctypes.c_void_p
    lib.rav1d_itx_frame_host.argtypes = ([P, P, P] + [ctypes.c_int] * 7
                                         + [P, ctypes.c_int])
    lib.rav1d_itx_frame_host.restype = ctypes.c_int
    return lib


def run_host(lib, args):
    """Run the host build over frame_args'/batch_args' tuple."""
    assert lib.rav1d_itx_frame_host(*cuda_itx.c_args(args)) == 0


@pytest.fixture(scope="module")
def host_itx(tmp_path_factory):
    return build_host_itx(tmp_path_factory.mktemp("itx"))


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("wh", SIZES + ["wht"],
                         ids=[f"{w}x{h}" for w, h in SIZES] + ["wht"])
def test_kernel_source_matches_twin_on_host(host_itx, wh, bpc):
    w, h = (4, 4) if wh == "wht" else wh
    cb, f, s = _inputs(w, h, bpc, 1000, 31 * w + h + bpc)
    cb, f, s = map(torch.from_numpy, (cb, f, s))
    out = torch.zeros((cb.shape[0], h, w), dtype=torch.int32)
    if wh == "wht":
        args = cuda_itx.batch_args(cb, [], out, w, h, bpc)
        ref = TK.wht_core(cb)
    else:
        args = cuda_itx.batch_args(cb, [f, s], out, w, h, bpc)
        ref = TK.itx_any_core(cb, f, s, w, h, bpc)
    run_host(host_itx, args)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
