"""Archive bytes over input bytes, over the window's files: what users
store."""


def read(r):
    return r.bytes_out / r.bytes_in if r.direction == "compress" else None
