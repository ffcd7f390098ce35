"""The 95th percentile, over every step of the window, of the interval
between consecutive step completions (CUDA events recorded after each
step), ms."""

from benchmark import stats


def read(reading):
    return stats.percentile(stats.intervals(reading.window.stamps_ms), 95)
