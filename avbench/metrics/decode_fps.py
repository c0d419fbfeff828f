"""decode_fps (frames/s, higher is better; host clock): pictures returned
by get_picture in the window over the window's time."""


def read(run):
    w = run.window
    return w.pictures / w.seconds if w.pictures else None
