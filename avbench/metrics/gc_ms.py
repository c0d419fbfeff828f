"""gc_ms (ms/frame; host runtime): the Python collector's time over the
window, every generation (gc.callbacks), per picture."""


def read(run):
    t = run.tracer
    if t is None or not run.window.pictures:
        return None
    return 1e3 * t.gc_s / run.window.pictures
