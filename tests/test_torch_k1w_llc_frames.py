"""PD keys of several llc frames redesigned for Hopper (``csrc/engine_k1w.cu``,
one warp per env), on the CPU: K1b at two llc frames, its split twin K1h-b
at two, and Cassie's and Cassie2D's K1e at five, each on the generic
warp-per-env instance of its key (``ops/cuda/engine.py::warp_instance``,
built from ``-DK1W_*`` flags at the host's launch shape). The source's
per-env code is built by g++ under ``-DK1W_HOST_CHECK`` (lane width 1, the
collectives identities) and run as a loop over envs, beside the
thread-per-env twins (``-DK1_HOST_CHECK``: the named ``k1b_..._llc2``,
``K1_ONLY`` 3, and the generic ``k1_..._llc2_si`` and
``k1_nl17_..._llc5_p2p2[_planar]``), all built side by side once per module.

- Routing: each key picks its generic warp-per-env instance
  (``k1w``, the key's tags, the launch shape), as the env's control step
  builds the unit under the configuration; ``thread_per_env=True`` gives the
  ``engine_k1.cu`` twin; a torque key of several llc frames stays refused
  by the warp source (``warp_holds``; the source's ``static_assert(PD ||
  NLLC == 1)``).
- The env size the host picks the launch shape from
  (``engine.warp_env_bytes``) is the source's own ``sizeof`` of the env
  (``<sym>_env_bytes``), and the table the library reads is the wrapper's.
- Near contact and lifted (walker bases 3 m up, Cassie's pelvis 1 m up:
  every contact row skipped), each warp build agrees with the port's plain
  unit, whose frame loop refreshes the torque from each frame's q, carries
  λ across frames and makes the factor at each frame's first substep: the
  walker keys at B = 16 on chip_smoke.py's PD-target states at K1b's gate
  ``TOL`` (per-env medians, the largest env within ten times), Cassie at
  B = 64 on its states at ``TOL_EQ`` with the 99th percentile; and with its
  thread-per-env twin's host build: the walker keys at ``TOL_TWIN``, the
  largest env within ten times, Cassie at K1e's twin gate (``TOL_EQ``, the
  p99; tests/test_torch_k1w_cassie.py says why).
- The carry across frames: lifted with every joint inside its limits (no
  row active, λ stays 0), two frames in one call equal the one-frame warp
  instance run twice, bit for bit (frame 2 starts from frame 1's q and q̇,
  its torque and its factor from frame 2's q); near contact they part by
  more than the plain gate, as λ is carried. The split key at two frames
  equals the unsplit one bit for bit there too (every bias 0).

The JAX package's walker control step at two llc frames is held against the
K1b warp host build in tests/test_torch_pd_child.py
(``test_pd_control_step_matches_jax``). Cassie at five frames is held here
to the port's plain path only: that frame loop is held to the JAX package's
at ten frames (tests/test_torch_k1w_cassie.py::
test_k1w_cassie_matches_jax_control_step) and at one and two frames
(``test_pd_control_step_matches_jax``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import cassie, walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL, TOL_EQ, TOL_TWIN = chip_smoke.TOL, chip_smoke.TOL_EQ, chip_smoke.TOL_TWIN
W = "nl22_ns14_nlim21_sub4_it4"
C = "nl17_ns5_nlim16_sub2_it4"
# the new keys and their thread-per-env twins' symbols (K1b's named K1_ONLY 3)
KINDS = ("k1b_llc2", "k1h_b_llc2", "cassie_llc5", "cassie2d_llc5")
TWIN = {"k1b_llc2": f"k1b_{W}_llc2", "k1h_b_llc2": f"k1_{W}_llc2_si",
        "cassie_llc5": f"k1_{C}_llc5_p2p2", "cassie2d_llc5": f"k1_{C}_llc5_p2p2_planar"}
KIND = pytest.mark.parametrize("kind", KINDS)
WALKER = pytest.mark.parametrize("kind", KINDS[:2])
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


def _walker_pd():
    """The walker's model with its PD gains, and its implicit derivative gain."""
    model = walker3d.make_model()
    kp = model.power_coef * (model.actuated > 0).float()
    return model.replace(kp=kp), kp / 20.0


def _kernel(kind, thread_per_env=False, frames=None):
    """The wrapper of ``kind`` (``frames`` llc frames in its place)."""
    if kind.startswith("cassie"):
        model = cassie.make_model()
        spec = dataclasses.replace(cassie.constraints(), planar=kind.startswith("cassie2d"))
        return engine.K1e(model, dataclasses.replace(CASSIE_CONFIG, llc_frames=frames or 5),
                          spec, pd_mode=True, extra_damping=model.actuated * model.kd,
                          thread_per_env=thread_per_env)
    model, damping = _walker_pd()
    config = EngineConfig(llc_frames=frames or 2, split_impulse=kind == "k1h_b_llc2")
    return engine.K1b(model, config, extra_damping=damping, thread_per_env=thread_per_env)


@pytest.fixture(scope="module")
def libs():
    """The new warp-per-env instances, their thread-per-env twins and the
    walker keys' one-frame warp-per-env instances, built by g++ side by side."""
    return build_host([*(_kernel(kind, tpe) for kind in KINDS for tpe in (False, True)),
                       *(_kernel(kind, frames=1) for kind in KINDS[:2])])


def _states(kind, lifted=False):
    """Numpy ``(q, qd, targets, ground_z, friction)``: chip_smoke.py's
    PD-target walker states (B = 16, near contact) or Cassie states near the
    stand (B = 64); ``lifted`` raises every base 3 m (Cassie's 1 m)."""
    if kind.startswith("cassie"):
        model = cassie.make_model()
        arrays = chip_smoke.cassie_states(model, cassie.stand_q(model), cassie.initial_z(),
                                          np.random.default_rng(57), "2d" in kind, 64)
    else:
        arrays = chip_smoke.pd_target_states(walker3d.make_model(), np.random.default_rng(57),
                                             16)
    arrays = [np.ascontiguousarray(x) for x in arrays]
    if lifted:
        arrays[0][:, 2] += 1.0 if kind.startswith("cassie") else 3.0
    return arrays


def _gate(got, want, tol, tail="max"):
    """Per-env medians of the max |Δ| within ``tol``; the largest env (or,
    with ``tail="p99"``, the 99th percentile) within ten times."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        worst = np.quantile(per_env, 0.99) if tail == "p99" else per_env.max()
        assert worst <= 10 * tol[name], (name, tail, float(worst))


@KIND
def test_llc_keys_pick_the_generic_warp_instance(kind):
    kernel, twin = _kernel(kind), _kernel(kind, thread_per_env=True)
    key, inst = kernel.key, kernel.instance
    assert key.pd and key.llc == (5 if kind.startswith("cassie") else 2)
    assert engine.warp_holds(key) and key not in engine.WARP_INSTANCES
    assert inst == engine.warp_instance(key) and inst.source == engine.SOURCE_W
    envs, blocks = engine.warp_shape(key)
    assert (inst.envs, inst.blocks) == (envs, blocks) and blocks == 1
    assert envs == (32 if kind.startswith("cassie") else 18)
    tags = engine.canonical_symbol(key).removeprefix("k1")
    assert TWIN[kind].endswith(tags) and kernel.name == f"k1w{tags}_{envs}x{blocks}"
    flags = engine.compile_flags(inst)
    assert flags[0] == f"-DK1W_NAME={kernel.name}" and f"-DK1W_NLLC={key.llc}" in flags
    assert "-DK1W_PD=true" in flags and not any(f.startswith("-DK1_") for f in flags)
    assert twin.name == TWIN[kind] and twin.instance.source == engine.SOURCE
    assert (twin.instance.index == 3) == (kind == "k1b_llc2") and twin.key == key
    assert kernel.variant == twin.variant == {"k1b_llc2": "k1b", "k1h_b_llc2": "k1h_b"}.get(
        kind, "k1e")
    # the same key in torque mode stays off the warp source
    assert not engine.warp_holds(dataclasses.replace(key, pd=False))


@pytest.mark.parametrize("family, kind", [
    ("Walker3DPDCustomEnv-v0", "k1b_llc2"), ("Child3DPDCustomEnv-v0", "k1h_b_llc2"),
    ("CassieEnv-v0", "cassie_llc5"), ("Cassie2DEnv-v0", "cassie2d_llc5")],
    ids=["pd_walker", "pd_child_split", "cassie", "cassie2d"])
def test_make_builds_the_generic_warp_instance(family, kind):
    """The env's unit under the configuration, as make() builds its model and
    its control step builds the unit, picks the generic warp-per-env
    instance of its key."""
    want = _kernel(kind)
    env = mocca_envs_tpu_torch.make(family, device="cpu", config=want.config)
    model = env.model
    if kind.startswith("cassie"):
        picked = engine.make_kernel(model, want.config, pd_mode=True,
                                    constraints=want.constraints,
                                    extra_damping=model.actuated * model.kd)
    else:
        picked = engine.make_kernel(model, want.config, pd_mode=True,
                                    extra_damping=model.kp / 20.0)
    assert picked.key == want.key and picked.instance == want.instance


@KIND
def test_env_bytes_are_the_sources(libs, kind):
    """The env's bytes the host picked the launch shape from, and the table
    size, are the library's own."""
    kernel = _kernel(kind)
    lib = libs[kernel.name]
    assert getattr(lib, kernel.name + "_env_bytes")() == engine.warp_env_bytes(kernel.key)
    assert engine.layout(lib, kernel.name) == (engine.table_floats(kernel.key), 0)
    assert engine.table_floats(kernel.key) == kernel.table_host.size


@KIND
@LIFT
def test_llc_keys_match_plain_and_thread_per_env_on_host(libs, kind, lifted):
    """Both designs against the plain unit at their key's chip gate, and the
    two designs against each other at the twin gate."""
    cas = kind.startswith("cassie")
    new, old = _kernel(kind), _kernel(kind, thread_per_env=True)
    inputs = _states(kind, lifted)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    outs = run_on_host(libs[new.name], new, inputs)
    base = run_on_host(libs[old.name], old, inputs)
    tail = "p99" if cas else "max"
    for got in (outs, base):
        assert all(np.isfinite(o).all() for o in got)
        _gate(got, want, TOL_EQ if cas else TOL, tail)
    _gate(outs, base, TOL_EQ if cas else TOL_TWIN, tail)
    if lifted:
        assert (want[3] == 0).all() and (outs[3] == 0).all()
    else:
        assert (want[3] > 0).any(axis=1).mean() > 0.1          # contacts carry load
    # the servo moved the joints over the frames
    assert np.abs(outs[0][:, 7:] - inputs[0][:, 7:]).max() > 1e-3


def _inside_limits(kind):
    """The lifted states with every joint 0.3 rad and every target 0.35 rad
    inside its limits (past the 0.15 rad margin) and a tenth of the speeds:
    no row is active in any substep of the two frames."""
    q, qd, targets, gz, fric = _states(kind, lifted=True)
    model = walker3d.make_model()
    lo, hi = model.limit_lo.numpy(), model.limit_hi.numpy()
    q[:, 7:] = np.clip(q[:, 7:], lo + 0.3, hi - 0.3)
    targets = np.clip(targets, lo + 0.35, hi - 0.35).astype(np.float32)
    return [q, (0.1 * qd).astype(np.float32), targets, gz, fric]


@WALKER
@pytest.mark.parametrize("case", ["inside_limits", "near_contact"])
def test_two_frames_carry_the_state_across(libs, kind, case):
    """With no row active (λ stays 0) two llc frames in one call are the
    one-frame instance run twice, bit for bit: frame 2 starts from frame 1's
    q and q̇, its torque and factor made from them. Near contact λ is
    carried across the frames, which parts the two by more than ten times
    the plain gate's q̇ in the envs where rows are active."""
    two, one = _kernel(kind), _kernel(kind, frames=1)
    assert one.instance.index is not None and one.instance.source == engine.SOURCE_W
    inputs = _inside_limits(kind) if case == "inside_limits" else _states(kind)
    outs = run_on_host(libs[two.name], two, inputs)
    half = run_on_host(libs[one.name], one, inputs)
    twice = run_on_host(libs[one.name], one, [half[0], half[1], *inputs[2:]])
    if case == "inside_limits":
        assert all(np.array_equal(a, b) for a, b in zip(outs, twice))
        lim_act, con_act, _ = engine.k1_activity(two, *map(torch.as_tensor, inputs))
        assert not lim_act.any() and not con_act.any()
        # frame 2's torque came from frame 1's q: the joints moved again
        assert np.abs(outs[0][:, 7:] - half[0][:, 7:]).max() > 1e-3
    else:
        worst = float(np.abs(outs[1] - twice[1]).max())
        assert worst > 10 * TOL["qd"], worst


def test_split_equals_unsplit_where_every_bias_is_0(libs):
    """K1h-b at two frames is K1b at two frames where nothing is active:
    every push-out bias 0, the position pass a no-op, bit for bit."""
    split, unsplit = _kernel("k1h_b_llc2"), _kernel("k1b_llc2")
    inputs = _inside_limits("k1h_b_llc2")
    a = run_on_host(libs[split.name], split, inputs)
    b = run_on_host(libs[unsplit.name], unsplit, inputs)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
