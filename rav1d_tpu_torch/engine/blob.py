"""The frame blob: its host word allocator and its upload, one int32 device
tensor per frame.

`bucket_pow2` and `FrameBlob` (its allocator half) are copies of
rav1d_tpu/engine/blob2.py, and `det_cap_words` of run2.det_cap_words;
`Uploader` ports FrameBlob.upload. The used prefix of the blob is written
into a reused staging buffer (page-locked for a CUDA device), copied to the
device in one host-to-device transfer, and zero-padded there to the
capacity the JAX engine pads to (det_cap_words, rounded up to a power of
two), so every region read lands inside the tensor exactly as it does in
the reference. `FetchPool` is the other direction (run2's deferred fetch,
run2.py:1101-1175): the host buffers the frames' outputs are copied into,
and the pictures whose copy is not complete yet.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


def bucket_pow2(n, lo=4096):
    b = lo
    while b < n:
        b <<= 1
    return b


def det_cap_words(psz, bpc):
    """Device blob capacity for a frame geometry, the one the JAX engine
    pads to (a stable compile key there); a frame that overflows it pads
    to the next power of two of its own size."""
    return bucket_pow2(psz * (8 if bpc == 8 else 16))


class FrameBlob:
    """Sequential word allocator over the frame's staging buffer."""

    __slots__ = ("parts", "zparts", "pos")

    def __init__(self, hdr_len):
        self.parts = []
        self.zparts = []  # (off, n) regions explicitly zeroed at upload
        self.pos = hdr_len  # header region occupies [0, hdr_len)

    def alloc_zeros(self, n):
        """Reserve an n-word all-zero region (e.g. a no-op filter map);
        zeroed at upload since the staging buffer is reused across frames."""
        off = self.pos
        self.pos += n
        self.zparts.append((off, n))
        return off

    def add_words(self, arr_i32):
        """Append an int32 ndarray; returns its word offset."""
        a = np.ascontiguousarray(arr_i32, dtype=np.int32).reshape(-1)
        off = self.pos
        self.parts.append((off, a))
        self.pos += a.size
        return off

    def add_i16(self, arr):
        """Append an int16 array packed two-per-word (little-endian pair
        order matches lax.bitcast_convert_type int32->int16 lane order).
        Returns the word offset; element i lives at word off + i//2."""
        a = np.ascontiguousarray(arr, dtype=np.int16).reshape(-1)
        if a.size & 1:
            a = np.concatenate([a, np.zeros(1, np.int16)])
        return self.add_words(a.view(np.int32))

    def add_u8(self, arr):
        """Append a uint8 array packed four-per-word; element i lives in
        byte lane i%4 of word off + i//4."""
        a = np.ascontiguousarray(arr, dtype=np.uint8).reshape(-1)
        pad = (-a.size) % 4
        if pad:
            a = np.concatenate([a, np.zeros(pad, np.uint8)])
        return self.add_words(a.view(np.int32))


class FetchPool:
    """Host buffers (page-locked for a CUDA device) that the frames' packed
    outputs are copied into with no host wait (engine/run.py execute), and
    the pictures whose copy is still pending, oldest first. A picture's
    `materialize` completes its fetch and gives the buffer back. At most
    `depth` buffers exist: when none is free, the oldest pending picture is
    completed first (rav1d_tpu's FETCH_LAG rule), which waits only for a
    frame queued before the one that asks. One lock: the frame ring's
    worker starts fetches while the decoder's thread completes them. A
    fetch completes inside `torch.cuda.device` of the pool's device,
    whatever thread asks."""

    def __init__(self, device, depth):
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        self.depth = depth
        self.free = []
        self.count = 0  # buffers in existence, free or held
        self.pending = []  # [(picture, buffer, finish)]
        self.lock = threading.RLock()

    def take(self, nbytes):
        """A uint8 host buffer of at least `nbytes` bytes."""
        with self.lock:
            while True:
                fit = [b for b in self.free if b.numel() >= nbytes]
                if fit:
                    buf = min(fit, key=torch.Tensor.numel)
                    self.free.remove(buf)
                    return buf
                if self.count < self.depth:
                    self.count += 1
                    return torch.empty(bucket_pow2(nbytes), dtype=torch.uint8,
                                       pin_memory=self.pin)
                if self.free:  # every free buffer is too small
                    self.free.pop()
                    self.count -= 1
                else:
                    self.complete(self.pending[0][0])

    def add(self, pic, buf, finish):
        """Register `pic` as pending on `buf`; `finish()` waits for the copy
        and fills the picture's planes."""
        with self.lock:
            self.pending.append((pic, buf, finish))
            pic._pending_fetch = self

    def complete(self, pic):
        """Run the pending fetch of `pic`, if any, and free its buffer."""
        with self.lock:
            for i, (p, buf, finish) in enumerate(self.pending):
                if p is pic:
                    break
            else:
                return
            try:
                with (torch.cuda.device(self.device) if self.pin
                      else contextlib.nullcontext()):
                    finish()
            finally:  # only now: another thread's materialize waits here
                del self.pending[i]
                pic._pending_fetch = None
                self.free.append(buf)

    def release(self):
        """Drop every pending fetch, its picture's planes never filled, and
        every buffer (flush: nothing will read those pictures)."""
        with self.lock:
            for pic, _, _ in self.pending:
                pic._pending_fetch = None
            self.pending = []
            self.free = []
            self.count = 0


class Uploader:
    """Reused staging buffer + the event that guards its reuse, and the
    frames' fetch pool (`fetch_depth` host buffers)."""

    def __init__(self, device, fetch_depth=3):
        self.device = torch.device(device)
        self.staging = None
        self.event = None
        self.fetches = FetchPool(self.device, fetch_depth)

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
