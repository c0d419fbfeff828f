"""The 8x8 DCT_DCT inverse-transform batch and its kernel's wrapper.

`idct8x8_batch(cb, bpc)` is the port's counterpart of
rav1d_tpu/ops/pallas/itx8.py idct8x8_batch_pallas, with the same contract:
(N, 8, 8) int32 coefficients in natural order, N a multiple of 128,
(N, 8, 8) int32 residuals out, bpc 8/10/12. For a CUDA tensor it launches
the hand-written kernel (csrc/itx.cu rav1d_idct8x8, built at first use) on
the current stream, or raises; for a CPU tensor it runs the plain version,
`idct8x8_batch_plain`: the engine's itx_any_core with both 1-D codes 0
(DCT), as idct8x8_batch_jnp is for JAX. There is no fallback from the card
to the plain version. `launches` counts the kernel launches.

No decoder path calls it: the resid program runs the 8x8 class through the
itx kernel, as the JAX engine does.
"""

from __future__ import annotations

import torch

from ..engine.kernels import itx_any_core
from .cuda import itx as cuda_itx

LANES = 128  # the batch granule of the TPU kernel's contract

launches = 0


def idct8x8_batch_plain(cb, bpc=8):
    """Plain torch version: (N, 8, 8) int32 -> (N, 8, 8) int32."""
    z = torch.zeros(cb.shape[0], dtype=torch.int32, device=cb.device)
    return itx_any_core(cb, z, z, 8, 8, bpc)


def idct8x8_batch(cb, bpc=8):
    """Inverse-transform a (N, 8, 8) int32 DCT_DCT batch; N % 128 == 0."""
    global launches
    n = cb.shape[0]
    if cb.dtype != torch.int32 or tuple(cb.shape[1:]) != (8, 8):
        raise ValueError(f"idct8x8: cb must be int32 (N, 8, 8), got "
                         f"{cb.dtype} {tuple(cb.shape)}")
    if n % LANES:
        raise ValueError(f"idct8x8: N must be a multiple of {LANES}, got {n}")
    if bpc not in (8, 10, 12):
        raise ValueError(f"idct8x8: bpc {bpc}")
    if cb.device.type == "cpu":
        return idct8x8_batch_plain(cb, bpc)
    if cb.device.type != "cuda":
        raise ValueError(f"idct8x8: unsupported device {cb.device}")
    cb = cb.contiguous()
    out = torch.empty_like(cb)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(cb.device).cuda_stream
    rc = cuda_itx.lib().rav1d_idct8x8(cb.data_ptr(), out.data_ptr(), n, bpc,
                                      stream)
    if rc != 0:
        raise RuntimeError(f"idct8x8 kernel launch failed: cuda error {rc}")
    launches += 1
    return out
