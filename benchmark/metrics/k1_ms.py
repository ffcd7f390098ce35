"""Device ms a step of the K1 launches in the traced stretch: the kernels
whose name holds the configuration type of an instance the program counted
there."""


def read(reading):
    t = reading.trace
    if t is None or not t.k1:
        return None
    return t.per_step(t.k1_us()) / 1e3
