"""mocca_envs_tpu_torch: the PyTorch/CUDA port of mocca_envs_tpu.

The same batched locomotion envs as the JAX package, written in PyTorch
with the TPU kernels re-written by hand for NVIDIA Hopper. Entry points:

    env = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0")     # on CUDA
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 4096, seed=0)
    state = batch.init(); tr = batch.step(state, actions)

Both run on the CUDA card unless given ``device="cpu"``. The package never
imports JAX.
"""

from mocca_envs_tpu_torch.envs.env import BatchedEnv  # noqa: F401
from mocca_envs_tpu_torch.envs.registry import make, registered_envs  # noqa: F401

__version__ = "0.1.0"
