"""rav1d_tpu_torch.Decoder: the rav1d_tpu decoder with its dense pass on
a torch device.

The host front end (demux, OBU parsing, the C syntax pass) is the
reference decoder's own: this class wraps a rav1d_tpu.Decoder and, for the
length of each call into it, installs the port's dense pass in place of
rav1d_tpu.recon.frame.decode_frame_dense (the hook bench.py and
parallel/resid.py also use). The reference's own engine switch
(RAV1D_ENGINE) must stay off, which keeps its fetch ring and warm pool
off; each frame's pixels are on the host when the frame is handed out.

Frames outside the port's slice raise NotImplementedError instead of
decoding on the host: inter frames, bit depths other than 8, layouts other
than 4:2:0, superres. The reference planner's own host gates (intra block
copy) still run the host path, counted in engine.stats["fallback"].
"""

from __future__ import annotations

import contextlib

import torch

import rav1d_tpu
from rav1d_tpu import engine as _ref_engine
from rav1d_tpu.decoder import DecodeError
from rav1d_tpu.headers import PixelLayout
from rav1d_tpu.recon import frame as _frame

from . import engine
from .engine.blob import Uploader


def check_slice(f):
    """Raise NotImplementedError for a frame the port does not decode."""
    fh = f.frame_hdr
    if not fh.frame_type.is_key_or_intra:
        raise NotImplementedError("inter frames are not ported yet")
    if f.cur.bpc != 8:
        raise NotImplementedError(f"{f.cur.bpc}-bit frames are not ported yet")
    if f.cur.layout != PixelLayout.I420:
        raise NotImplementedError(
            f"layout {f.cur.layout.name} is not ported yet (4:2:0 only)")
    if fh.size.width[0] != fh.size.width[1]:
        raise NotImplementedError("superres frames are not ported yet")


class Decoder:
    """AV1 decoder whose dense pass runs on `device` (default: the first
    CUDA card). Same send_data / get_picture / flush as rav1d_tpu.Decoder."""

    def __init__(self, settings=None, device=None):
        if _ref_engine.enabled():
            raise RuntimeError("rav1d_tpu_torch.Decoder needs the reference "
                               "engine off: unset RAV1D_ENGINE")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the port's plain versions on the CPU")
        self.inner = rav1d_tpu.Decoder(settings)
        self.uploader = Uploader(self.device)
        self._orig = None

    def _dense(self, f):
        check_slice(f)
        _frame.materialize_work_items(f)
        t = f._dense_args[0]
        if engine.run_dense(t, f, self.uploader):
            f._dense_args = None
            f.work_items = []
        else:
            self._orig(f)  # the reference's host path

    @contextlib.contextmanager
    def _installed(self):
        self._orig = _frame.decode_frame_dense
        _frame.decode_frame_dense = self._dense
        try:
            yield
        except DecodeError as e:
            # the reference reports every failure as a DecodeError; a
            # frame outside the slice is not a bitstream error
            if isinstance(e.__cause__, NotImplementedError):
                raise e.__cause__ from None
            raise
        finally:
            _frame.decode_frame_dense = self._orig

    def send_data(self, data, timestamp=0):
        with self._installed():
            return self.inner.send_data(data, timestamp)

    def get_picture(self):
        with self._installed():
            return self.inner.get_picture()

    def flush(self):
        with self._installed():
            return self.inner.flush()

    def close(self):
        self.flush()
