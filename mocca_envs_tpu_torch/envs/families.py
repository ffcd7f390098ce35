"""Env family registration: the fifteen families of the JAX package.

Counterpart of ``mocca_envs_tpu/envs/families.py``: the walk-to-target
walkers (torque and PD, adult and child, and the planar Walker2D / Crab2D),
the stepping-stone walker, the Cassie families, the brachiating monkey, the
walkers over fractal terrain (with and without the LIDAR fan) and the walker
over a triangle-mesh staircase.
"""

from __future__ import annotations

import dataclasses
import functools

from mocca_envs_tpu_torch.envs.registry import register
from mocca_envs_tpu_torch.tasks.cassie_task import make_cassie
from mocca_envs_tpu_torch.tasks.monkey_stepper import make_monkey3d_stepper
from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams, make_walker3d_custom
from mocca_envs_tpu_torch.tasks.walker_stepper import make_walker3d_stepper
from mocca_envs_tpu_torch.tasks.walker_terrain import make_walker3d_terrain
from mocca_envs_tpu_torch.terrain.scene import stairs_trimesh

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


register("CassieEnv", make_cassie)
register("Cassie2DEnv", functools.partial(make_cassie, name="Cassie2DEnv", planar=True))


def _make_cassie_phase(planar: bool = False, **kw):
    # the phase variants track a reference motion; the default table is the
    # synthesized parametric walk, to be swapped for a recorded one through
    # models/cassie_gait.py::from_npz
    from mocca_envs_tpu_torch.models.cassie_gait import synthesized_walk

    name = "CassiePhase2DEnv" if planar else "CassiePhaseEnv"
    return make_cassie(name=name, planar=planar, phase_obs=True,
                       ref_gait=synthesized_walk(), **kw)


register("CassiePhaseEnv", _make_cassie_phase)
register("CassiePhase2DEnv", functools.partial(_make_cassie_phase, planar=True))


def _make_walker2d_custom(**kw):
    from mocca_envs_tpu_torch.models import walker2d

    return make_walker3d_custom(
        model=kw.pop("model", None) or walker2d.make_walker2d(),
        name="Walker2DCustomEnv",
        initial_z=walker2d.WALKER2D_INITIAL_Z,
        constraints=walker2d.planar_spec(),
        terminal_link_names=("base",),
        **kw,
    )


def _make_crab2d_custom(**kw):
    from mocca_envs_tpu_torch.models import walker2d

    # the crab is low-slung: its base spawns at z = 0.45, under the walkers'
    # terminal height of 0.7, which would end every episode at its first
    # step; 0.2 is about the same fraction of standing height (0.7 / 1.3)
    params = kw.pop("params", None) or dataclasses.replace(
        WalkerParams.default(), terminal_height=0.2)
    return make_walker3d_custom(
        model=kw.pop("model", None) or walker2d.make_crab2d(),
        name="Crab2DCustomEnv",
        initial_z=walker2d.CRAB2D_INITIAL_Z,
        params=params,
        constraints=walker2d.planar_spec(),
        terminal_link_names=("base",),
        **kw,
    )


register("Walker2DCustomEnv", _make_walker2d_custom)
register("Crab2DCustomEnv", _make_crab2d_custom)
register("Monkey3DStepperEnv", make_monkey3d_stepper)
register("Walker3DTerrainEnv", make_walker3d_terrain)
register(
    "Walker3DTerrainLidarEnv",
    functools.partial(make_walker3d_terrain, name="Walker3DTerrainLidarEnv", lidar=True),
)


def _make_walker3d_stairs(**kw):
    """The walker walking to a target over a triangle-mesh staircase in
    front of its start: 6 steps of rise 0.12 m and run 0.35 m, 4 m wide,
    from x = 0.6 m (24 faces, culled to ``tri_window`` per control step),
    over the plane z = 0; targets 1–2.5 m away."""
    params = kw.pop("params", None) or dataclasses.replace(
        WalkerParams.default(), target_dist_lo=1.0, target_dist_hi=2.5)
    return make_walker3d_custom(
        name="Walker3DStairsEnv",
        params=params,
        scene_builder=lambda device: stairs_trimesh(
            n_steps=6, rise=0.12, run=0.35, width=4.0, start_x=0.6, device=device),
        **kw,
    )


register("Walker3DStairsEnv", _make_walker3d_stairs)
