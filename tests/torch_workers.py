"""One PyTorch thread per test process, for the port's CPU tests.

The suite runs under pytest-xdist, one process per worker. PyTorch's
intra-op pool would start one thread per core in each of them, and on a
shared CPU the port's small-batch ops then spend their time in the pool's
barriers: on an 8-core Intel Xeon, the walker's plain llc frame at B = 16
took 0.17 s alone at the default 8 threads and 3.0 s with six such
processes side by side, against
0.12–0.18 s at one thread each (B = 64: 6.0 s against 0.17–0.22 s). Every
port test module imports this one.
"""

import torch

torch.set_num_threads(1)
