"""The aten ops one ``BatchedEnv.step`` dispatches on the host, counted by a
``TorchDispatchMode`` inside the traced run's window (exact)."""


def read(reading):
    return reading.window.host_ops
