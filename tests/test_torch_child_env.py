"""PyTorch port vs the JAX package: the child walkers, batched (CPU).

``Child3DCustomEnv`` (torque) and ``Child3DPDCustomEnv`` (PD) step by step
from shared states and actions with resync: done flags equal every step,
rewards within 1e-4, observations within 1e-4 on the per-env median and
1e-3 on the max, auto-reset on the same steps.

The torque child gets actions in ±0.25: its torque scales with s³ and its
inertia with s⁵, so at s = 0.5 a full action accelerates its joints four
times as hard as the adult's, and the joint-velocity terms of the
observation would carry four times the contact solver's fp-order noise.
"""

import pytest

from tests import torch_workers  # noqa: F401
from tests.test_torch_pd_child import check_family_step_by_step


@pytest.mark.parametrize("env_id, action_scale", [
    ("Child3DCustomEnv", 0.25), ("Child3DPDCustomEnv", 1.0)])
def test_child_env_matches_jax_step_by_step(env_id, action_scale):
    check_family_step_by_step(env_id, 10, action_scale)
