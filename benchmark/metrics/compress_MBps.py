"""Input bytes of every file compressed in the window over the window's
wall seconds, in 10^6 B/s."""


def read(r):
    return r.bytes_in / r.window_s / 1e6 if r.direction == "compress" else None
