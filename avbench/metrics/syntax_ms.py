"""syntax_ms (ms/frame; front end): recon/frame.py decode_frame_syntax,
the C syntax pass, on the host clock."""

from avbench.metrics._common import span_ms_per_picture


def read(run):
    return span_ms_per_picture(run, "syntax")
