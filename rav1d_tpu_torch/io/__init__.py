"""Container demuxers and raw-output muxers (behavior parity: rav1d tools/)."""

from .ivf import IvfDemuxer, probe_demuxer
from .muxers import Md5Muxer, Y4mMuxer, YuvMuxer, NullMuxer, make_muxer

__all__ = [
    "IvfDemuxer",
    "probe_demuxer",
    "Md5Muxer",
    "Y4mMuxer",
    "YuvMuxer",
    "NullMuxer",
    "make_muxer",
]
