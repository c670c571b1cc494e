"""The share of the traced window in copies between host and card
(``Memcpy`` device events): the volume in, the sums and weight out."""


def read(r):
    ms, n = r.name_ms("Memcpy")
    if not n or r.window_s <= 0:
        return None
    return 100.0 * ms / 1e3 / r.window_s
