"""Upload of the packed frame blob: one int32 device tensor per frame.

Port of rav1d_tpu/engine/blob2.py FrameBlob.upload. The used prefix of the
blob is written into a reused staging buffer (page-locked for a CUDA
device), copied to the device in one host-to-device transfer, and
zero-padded there to the capacity the JAX engine pads to
(run2.det_cap_words, rounded up to a power of two), so every region read
lands inside the tensor exactly as it does in the reference.
"""

from __future__ import annotations

import torch

from rav1d_tpu.engine.blob2 import bucket_pow2

from .pack import det_cap_words


class Uploader:
    """Reused staging buffer + the event that guards its reuse."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.staging = None
        self.event = None

    def _buffer(self, n):
        if self.staging is None or self.staging.numel() < n:
            pin = self.device.type == "cuda"
            self.staging = torch.empty(bucket_pow2(n), dtype=torch.int32,
                                       pin_memory=pin)
        elif self.event is not None:
            # the previous frame's copy must have left the buffer
            self.event.synchronize()
        return self.staging

    def upload(self, pack, psz, bpc):
        """FramePack -> (device int32 tensor of the blob's capacity, cap)."""
        blob, hdr = pack.blob, pack.hdr
        cap = bucket_pow2(max(blob.pos, hdr.size, det_cap_words(psz, bpc)))
        buf = self._buffer(blob.pos)
        pack.write_into(buf[: blob.pos].numpy())
        dev = torch.zeros(cap, dtype=torch.int32, device=self.device)
        if self.device.type == "cuda":
            dev[: blob.pos].copy_(buf[: blob.pos], non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            dev[: blob.pos].copy_(buf[: blob.pos])
        return dev, cap
