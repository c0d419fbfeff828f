"""The benchmark's plain reference: a frozen copy of the AV1 decoder's
numpy host path (the dav1d-style state machine, the OBU parser, the C
syntax pass under csrc/host/, recon/, ops/ref/, tables/).

It imports numpy and the standard library only. The C syntax pass is
built with the system C compiler into this directory's build/ on first
import. Entry point: Decoder(Settings()), send_data / get_picture.
"""

from .decoder import DecodeError, Decoder, EAgain, Settings  # noqa: F401
