"""Device-busy ms a step outside the K1 launches (the union of the other
device events of the traced stretch): the env core, the task and the
packing on the device."""


def read(reading):
    t = reading.trace
    if t is None or not t.k1:
        return None
    return t.per_step(t.other_busy_us()) / 1e3
