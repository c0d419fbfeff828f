"""rav1d_tpu_torch: the rav1d_tpu decoder's device engine on PyTorch/CUDA.

The port of rav1d_tpu's device half (engine/, ops/) to torch, with the hand
written CUDA kernels under csrc/. It imports torch, numpy and the JAX-free
modules of rav1d_tpu (front end, planner, packers' inputs, tables), never
JAX. Entry point: Decoder(settings, device=torch.device("cuda")).
"""

from rav1d_tpu.decoder import DecodeError, EAgain, Settings  # noqa: F401

from .decoder import Decoder  # noqa: F401
