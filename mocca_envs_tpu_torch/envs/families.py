"""Env family registration: the families this port carries so far.

Counterpart of ``mocca_envs_tpu/envs/families.py``. Only the main path's
family is ported; the others come with later slices.
"""

from __future__ import annotations

from mocca_envs_tpu_torch.envs.registry import register
from mocca_envs_tpu_torch.tasks.walker_custom import make_walker3d_custom

register("Walker3DCustomEnv", make_walker3d_custom)
