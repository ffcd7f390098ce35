"""PyTorch port vs the JAX package: split impulse on Cassie and Cassie2D
(CPU).

``python -m mocca_envs_tpu.harness.train --split-impulse`` gives the Cassie
families ``CASSIE_CONFIG`` with the flag on. One whole PD control step (10
llc frames × 2 substeps, the PD torque refreshed per frame, the position
pass in each of the 20 substeps after the rods' rows) through the port's
plain path and the JAX package's ``make_control_step``, at B = 4, the JAX
side one env per call on threads (tests/test_torch_cassie_step.py's
``run_per_env``), on chip_smoke.py's states near the stand pose. The gates
of the non-split step test: per-env medians within q 2e-4, qd 5e-3, depth
2e-4, normal impulse 5e-3, the largest env within twenty times. The split
step must part from the unsplit one on the same inputs. The kernel the
card runs for this key, the warp-per-env instance of
``csrc/engine_k1w.cu`` (K1h-e, K1h-e2d), built by g++ under
``-DK1W_HOST_CHECK`` (tests/torch_k1_host.py), is held to the same JAX
outputs at the same gates.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu.models import cassie as jcassie
from mocca_envs_tpu.ops.step import ConstraintSpec as JSpec
from mocca_envs_tpu.ops.step import make_control_step as jcontrol
from mocca_envs_tpu.tasks.cassie_task import CASSIE_CONFIG as JCASSIE_CONFIG
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.models import cassie as tcassie
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.ops.step import make_control_step as tcontrol
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG as TCASSIE_CONFIG
from mocca_envs_tpu_torch.terrain import scene as tscene

from tests import torch_workers  # noqa: F401
from tests.test_torch_cassie_step import run_per_env
from tests.test_torch_split_families import TOL, T, _gate, _parts
from tests.torch_k1_host import build_host, run_on_host


def _warp_unit(planar):
    """The split K1e unit of Cassie (Cassie2D with the lock) that the card
    runs: its warp-per-env instance."""
    tm = tcassie.make_model()
    spec = dataclasses.replace(tcassie.constraints(), planar=planar)
    return engine.K1e(tm, dataclasses.replace(TCASSIE_CONFIG, split_impulse=True), spec,
                      pd_mode=True, extra_damping=tm.actuated * tm.kd)


@pytest.fixture(scope="module")
def warp_libs():
    """The two warp-per-env split instances built by g++, side by side."""
    return build_host([_warp_unit(planar) for planar in (False, True)])


@pytest.mark.parametrize("planar", [False, True], ids=["CassieEnv", "Cassie2DEnv"])
def test_cassie_split_control_step_matches_jax(warp_libs, planar):
    B = 4
    jm, tm = jcassie.make_model(), tcassie.make_model()
    jspec = jcassie.constraints()
    if planar:
        jspec = JSpec(**{**dataclasses.asdict(jspec), "planar": True})
    tspec = convert.constraint_spec_from_numpy(dataclasses.asdict(jspec))
    q, qd, targets, gz, fric = chip_smoke.cassie_states(
        tm, tcassie.stand_q(tm), tcassie.initial_z(), np.random.default_rng(41 + planar),
        planar, B)
    jstep = jcontrol(jm, dataclasses.replace(JCASSIE_CONFIG, split_impulse=True),
                     constraints=jspec, pd_targets=lambda a: a, extra_damping=jm.actuated * jm.kd)
    jit_step = jax.jit(lambda a, b, c: jstep(a, b, c, jscene.flat()))
    outs = run_per_env(jit_step.lower(q[0], qd[0], targets[0]).compile(), q, qd, targets)
    want = [np.stack([np.asarray(f(w)) for w in outs]) for f in (
        lambda w: w[0], lambda w: w[1], lambda w: w[2].contacts.depth,
        lambda w: w[2].normal_impulse)]
    got, unsplit = (_parts(tcontrol(
        tm, dataclasses.replace(TCASSIE_CONFIG, split_impulse=split), constraints=tspec,
        pd_targets=lambda a: a, extra_damping=tm.actuated * tm.kd)(
        *map(T, (q, qd, targets)), tscene.flat(B))) for split in (True, False))
    _gate(got, want, TOL, 20)
    unit = _warp_unit(planar)
    assert unit.instance.source == engine.SOURCE_W
    _gate(run_on_host(warp_libs[unit.name], unit, [q, qd, targets, gz, fric]), want, TOL, 20)
    assert (want[3] > 0).mean() > 0.1                        # the feet carry load
    assert np.abs(got[0] - unsplit[0]).max() > 1e-4          # the position pass moves q
