"""upload_ms (ms/frame; upload): engine/run.py stage_ms["upload"] (CUDA
events around engine/blob.py's upload) over the window."""

from avbench.metrics._common import stage_ms_per_picture


def read(run):
    return stage_ms_per_picture(run, "upload")
