"""Device events (kernels, copies, sets) in the traced stretch per step the
device ran there."""


def read(reading):
    t = reading.trace
    return None if t is None else t.per_step(len(t.device))
