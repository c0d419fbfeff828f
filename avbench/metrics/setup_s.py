"""setup_s (s, lower is better; host clock): from the start of the
harness to the opening of the window: imports, the CUDA context, the
kernels built or loaded, the stream written, one group decoded to warm
up."""


def read(run):
    return run.setup_s
