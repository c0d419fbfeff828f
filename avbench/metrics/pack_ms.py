"""pack_ms (ms/frame; pack): engine/run.py stage_ms["pack"] (the port's
own host-clock counter) over the window."""

from avbench.metrics._common import stage_ms_per_picture


def read(run):
    return stage_ms_per_picture(run, "pack")
