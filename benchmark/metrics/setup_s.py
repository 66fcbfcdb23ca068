"""Process start to the first timed call: imports, CUDA start, the
kernel library loaded (built, in a checkout's first run), the inputs and the
reference's archive made, the warm-up calls."""


def read(r):
    return r.setup_s
