"""The share of the traced stretch, from its first device event's start to
its last one's end, that no device event covers, %."""


def read(reading):
    t = reading.trace
    if t is None or not t.device or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
