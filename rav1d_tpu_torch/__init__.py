"""rav1d_tpu_torch: the rav1d_tpu AV1 decoder with its device engine on
PyTorch/CUDA.

The package carries its own host front end (demux, OBU parsing, the C
syntax pass, the numpy host path, the frame planner: copies of the JAX
package's JAX-free modules) and the port of the device half (engine/,
ops/) to torch, with the hand-written CUDA kernels under csrc/. It imports
torch and numpy, never JAX and nothing of rav1d_tpu. Entry point:
Decoder(settings, device=torch.device("cuda")).
"""

from .decoder import DecodeError, Decoder, EAgain, Settings  # noqa: F401
