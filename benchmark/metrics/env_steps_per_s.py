"""Env-steps per second: the batch times the control steps completed, over
the window's host-clock time from the first step's dispatch to the
synchronise after the last."""

from benchmark import stats


def read(reading):
    w = reading.window
    return stats.rate(w.num_envs * w.steps, w.window_s)
