"""K1's share of its roofline, %: the least time the card could take for a
step's K1 work (the larger of the frozen count's fp32 operations over 67
TFLOP/s and its bytes over 3.35 TB/s, the H100 SXM's published peaks at
700 W) over the K1 ms a step the trace read."""


def read(reading):
    t = reading.trace
    if t is None or not t.k1 or reading.k1_bound_ms is None:
        return None
    return 100.0 * reading.k1_bound_ms / (t.per_step(t.k1_us()) / 1e3)
