"""Set-up: from the process's start to the first timed step's dispatch,
seconds (imports, the card's context, make, the batch's first episodes,
loading or building the K1 libraries, the warm-up steps)."""


def read(reading):
    return reading.window.setup_s
