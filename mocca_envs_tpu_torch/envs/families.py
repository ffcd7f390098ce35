"""Env family registration: the families this port carries so far.

Counterpart of ``mocca_envs_tpu/envs/families.py`` for the walk-to-target
walkers (torque and PD, adult and child) and the stepping-stone walker; the
other families come with later slices.
"""

from __future__ import annotations

import dataclasses
import functools

from mocca_envs_tpu_torch.envs.registry import register
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams, make_walker3d_custom
from mocca_envs_tpu_torch.tasks.walker_stepper import make_walker3d_stepper

register("Walker3DCustomEnv", make_walker3d_custom)
# the PD-servoed walker: actions are joint-angle targets
register(
    "Walker3DPDCustomEnv",
    functools.partial(make_walker3d_custom, name="Walker3DPDCustomEnv", pd_control=True),
)
register("Walker3DStepperEnv", make_walker3d_stepper)


def _child3d_params() -> WalkerParams:
    """Child-scaled task parameters: the child's joint speeds run ~1/√s of
    the adult's, so the electricity weight is halved to keep the cost /
    progress ratio the adult trains under; target distances scale with
    walking speed (∝ √s) and the fall height with the body."""
    return dataclasses.replace(
        WalkerParams.default(), terminal_height=0.35, w_electricity=1.0,
        target_dist_lo=2.0, target_dist_hi=5.0,
    )


def _make_child3d_custom(device=None, **kw):
    from mocca_envs_tpu_torch.models import child3d

    return make_walker3d_custom(
        model=kw.pop("model", None) or child3d.make_model(),
        name=kw.pop("name", "Child3DCustomEnv"),
        initial_z=child3d.INITIAL_Z,
        params=kw.pop("params", None) or _child3d_params(),
        device=device,
        **kw,
    )


register("Child3DCustomEnv", _make_child3d_custom)
# the PD-servoed child: the actuation under which the scaled model learns
register(
    "Child3DPDCustomEnv",
    functools.partial(_make_child3d_custom, name="Child3DPDCustomEnv", pd_control=True),
)
