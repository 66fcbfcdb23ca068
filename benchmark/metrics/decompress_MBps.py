"""Bytes of text rendered in the window over the window's wall seconds,
in 10^6 B/s."""


def read(r):
    return r.bytes_out / r.window_s / 1e6 if r.direction == "decompress" else None
