"""The planar K1h-e and the split A-form redesigned for Hopper
(``csrc/engine_k1w.cu``, one warp per env): Walker2D's and Crab2D's torque
frame with the planar lock and split impulse, and the walker's frame on the
plane with split impulse in the A-form (``matfree_pgs=False``), on the CPU.
The warp-per-env source's per-env code is built by g++ under
``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run as a
loop over envs, beside the thread-per-env twins (``-DK1_HOST_CHECK``: the
generic ``engine_k1.cu`` instances ``k1_nl7_..._planar_si`` and
``k1_nl22_..._si_aform``), the planar K1e's and K1h-si's warp-per-env
instances.

- The keys pick the warp-per-env instances (``K1W_ONLY`` 17 / 18), as
  ``make`` builds them for Walker2D and Crab2D with split impulse and for
  the walker with ``EngineConfig(split_impulse=True, matfree_pgs=False)``;
  ``thread_per_env=True`` picks the twins.
- At B = 16 on chip_smoke.py's states (Walker2D and Crab2D near contact, a
  little out of their plane; the walker near contact), and with every base
  lifted 3 m, against the port's plain unit at the chip gate (the planar
  K1h-e's ``TOL_EQ``, the A-form's ``TOL``) and against the twin's host
  build at ``TOL_TWIN``; near contact the twins' per-env median of |Δq̇|
  lies within three times the median by which the twin parts from itself
  when q̇ is nudged by 1e-7 (relative, numpy seed 0), the chip's
  ``rounding_floor``.
- The planar K1h-e against the planar K1e's warp-per-env build: bit for bit
  where every push-out bias is 0 (every base lifted 3 m, every joint inside
  its limits), parting by more than the plain gate near contact.
- The A-form against K1h-si's warp-per-env build (the matrix-free form of
  the same iteration) at ``TOL_TWIN``, near contact and lifted.

The JAX package's split Walker2D step is held against the planar K1h-e host
build in tests/test_torch_split_rest.py, its split A-form walker step
against the A-form's host build in tests/test_torch_solver_options.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import walker2d, walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL, TOL_EQ, TOL_TWIN = chip_smoke.TOL, chip_smoke.TOL_EQ, chip_smoke.TOL_TWIN
B = 16
SPLIT = EngineConfig(split_impulse=True)
AFORM = EngineConfig(**chip_smoke.OPTION_CONFIGS["k1h_si_aform"])
SYMBOL = {"planar_si": "k1w_nl7_ns5_nlim6_sub4_it4_planar_si",
          "aform": "k1w_nl22_ns14_nlim21_sub4_it4_si_aform"}
ONLY = {"planar_si": 17, "aform": 18}
TWIN = {"planar_si": "k1_nl7_ns5_nlim6_sub4_it4_planar_si",
        "aform": "k1_nl22_ns14_nlim21_sub4_it4_si_aform"}
# the planar models and their stand heights (chip_smoke.py's)
PLANAR = {"walker2d": (walker2d.make_walker2d, 1.22), "crab2d": (walker2d.make_crab2d, 0.42)}
CASES = [*(("planar_si", m) for m in PLANAR), ("aform", "walker")]
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


def _kernel(kind, thread_per_env=False, model=None):
    if kind == "planar_si":
        return engine.K1e(model or walker2d.make_walker2d(), SPLIT, walker2d.planar_spec(),
                          thread_per_env=thread_per_env)
    return engine.K1hSi(model or walker3d.make_model(), AFORM, thread_per_env=thread_per_env)


def _matrix_free(kind, model):
    """The warp-per-env instance each is held to: the planar K1e (unsplit),
    K1h-si (the matrix-free form)."""
    if kind == "planar_si":
        return engine.K1e(model, EngineConfig(), walker2d.planar_spec())
    return engine.K1hSi(model, SPLIT)


@pytest.fixture(scope="module")
def libs():
    """The two warp-per-env instances, their twins and the two warp-per-env
    instances they are held to, built by g++ side by side (Crab2D shares
    Walker2D's)."""
    models = {"planar_si": walker2d.make_walker2d(), "aform": walker3d.make_model()}
    return build_host([*(_kernel(kind, tpe) for kind in SYMBOL for tpe in (False, True)),
                       *(_matrix_free(kind, m) for kind, m in models.items())])


def _states(kind, mix, batch=B, lifted=False):
    """(kernel, numpy ``(q, qd, tau, ground_z, friction)``) of chip_smoke.py's
    planar or near-contact walker states; ``lifted`` raises every base 3 m."""
    if kind == "planar_si":
        make, stand_z = PLANAR[mix]
        kernel = _kernel(kind, model=make())
        arrays = chip_smoke.planar_walker_states(kernel.model, stand_z,
                                                 np.random.default_rng(91), batch)
    else:
        kernel = _kernel(kind)
        arrays = chip_smoke.near_contact_states(kernel.model, np.random.default_rng(93), batch)
    arrays = [np.ascontiguousarray(x) for x in arrays]
    if lifted:
        arrays[0][:, 2] += 3.0
    return kernel, arrays


def _gate(got, want, tol):
    """Per-env medians of the max |Δ| within ``tol``, the largest env within
    ten times."""
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(g - w).max(axis=1)
        assert np.median(per_env) <= tol[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * tol[name], (name, float(per_env.max()))


@pytest.mark.parametrize("kind", list(SYMBOL))
def test_keys_pick_the_warp_per_env_instance(libs, kind):
    new, old = _kernel(kind), _kernel(kind, thread_per_env=True)
    assert new.name == SYMBOL[kind] and new.instance.source == engine.SOURCE_W
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={ONLY[kind]}"]
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert old.name == TWIN[kind] == engine.canonical_symbol(old.key)
    assert old.instance.source == engine.SOURCE and old.instance.index is None
    assert new.key == old.key and new.variant == old.variant == (
        "k1h_e" if kind == "planar_si" else "k1h_si_aform")
    # each family's model as make() builds its unit
    if kind == "planar_si":
        for env_id in ("Walker2DCustomEnv-v0", "Crab2DCustomEnv-v0"):
            model = mocca_envs_tpu_torch.make(env_id, device="cpu").model
            picked = engine.make_kernel(model, SPLIT, constraints=walker2d.planar_spec())
            assert type(picked) is engine.K1e and picked.name == new.name, env_id
    else:
        model = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu",
                                          config=AFORM).model
        picked = engine.make_kernel(model, AFORM)
        assert type(picked) is engine.K1hSi and picked.name == new.name
    # the same table; no global workspace (the twin's holds the A-form's A)
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert new.table_host.size == old.table_host.size
    assert engine.layout(libs[old.name], old.name)[1] > 0


@pytest.mark.parametrize("kind, mix", CASES)
@LIFT
def test_k1w_matches_plain_and_thread_per_env_on_host(libs, kind, mix, lifted):
    """Both designs against the plain unit at the chip gate, and the two
    designs against each other at ``TOL_TWIN``, within the rounding floor
    near contact."""
    new, inputs = _states(kind, mix, lifted=lifted)
    old = _kernel(kind, thread_per_env=True, model=new.model)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    outs = run_on_host(libs[new.name], new, inputs)
    base = run_on_host(libs[old.name], old, inputs)
    for got in (outs, base):
        assert all(np.isfinite(o).all() for o in got)
        _gate(got, want, TOL_EQ if kind == "planar_si" else TOL)
    _gate(outs, base, TOL_TWIN)
    if lifted:
        assert (want[3] == 0).all() and (outs[3] == 0).all()
    else:
        assert (want[3] > 0).mean() > 0.05                      # contacts carry load
        # the twins part by rounding, as far as a 1e-7 nudge of q̇ parts
        # the twin from itself
        nudged = list(inputs)
        noise = np.random.default_rng(0).standard_normal(inputs[1].shape)
        nudged[1] = (inputs[1] * (1 + 1e-7 * noise)).astype(np.float32)
        med = lambda a: float(np.median(np.abs(a[1] - base[1]).max(axis=1)))  # noqa: E731
        twin, floor = med(outs), med(run_on_host(libs[old.name], old, nudged))
        assert twin <= 3 * floor, (twin, floor)


@pytest.mark.parametrize("mix", list(PLANAR))
def test_planar_k1h_e_equals_the_planar_k1e_where_every_bias_is_zero(libs, mix):
    """Every base lifted 3 m and every joint 0.05 rad inside its limits: no
    contact row and no push-out bias in any substep (a limit row within its
    margin has none), and the planar K1h-e
    gives the planar K1e's bits; near contact the position pass moves the
    frame beyond the plain gate."""
    new, inputs = _states("planar_si", mix)
    unsplit = _matrix_free("planar_si", new.model)
    near = [x.copy() for x in inputs]
    lo, hi = new.model.limit_lo.numpy(), new.model.limit_hi.numpy()
    inputs[0][:, 2] += 3.0
    inputs[0][:, 7:] = np.clip(inputs[0][:, 7:], lo + 0.05, hi - 0.05)
    _, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    assert not con_act.any()
    outs = run_on_host(libs[new.name], new, inputs)
    for got, want in zip(outs, run_on_host(libs[unsplit.name], unsplit, inputs)):
        np.testing.assert_array_equal(got, want)
    assert not (outs[3] != 0).any()
    outs = run_on_host(libs[new.name], new, near)
    ref = run_on_host(libs[unsplit.name], unsplit, near)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL_EQ[name], (name, med)


@LIFT
def test_aform_matches_the_matrix_free_warp_build_on_host(libs, lifted):
    """The A-form and the matrix-free form of one warp-per-env design are the
    same iteration: on the same inputs they part only by the order of their
    sums, at the JAX package's gate between the two forms."""
    new, inputs = _states("aform", "walker", lifted=lifted)
    matfree = _matrix_free("aform", new.model)
    assert matfree.name == "k1w_nl22_ns14_nlim21_sub4_it4_si"
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, run_on_host(libs[matfree.name], matfree, inputs), TOL_TWIN)
    if not lifted:
        assert (outs[3] > 0).mean() > 0.05
