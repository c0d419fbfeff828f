"""get_wait_ms (ms/frame; frame ring): the caller's time inside
get_picture over the window, per picture returned."""


def read(run):
    w = run.window
    return 1e3 * w.get_s / w.pictures if w.pictures else None
