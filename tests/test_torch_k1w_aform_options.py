"""The walker's A-form and its all-options-off key redesigned for Hopper
(``csrc/engine_k1w.cu``, one warp per env): the walker's frame on the plane
with ``matfree_pgs=False``, alone and with ``block_pgs``, ``warm_start`` and
``reuse_factor`` off too (scalar friction rows, λ from zero and a factor in
every substep), on the CPU. The warp-per-env source's per-env code is built
by g++ under ``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities)
and run as a loop over envs, beside the thread-per-env twins
(``-DK1_HOST_CHECK``: the generic ``engine_k1.cu`` instances
``k1_nl22_..._aform`` and ``k1_nl22_..._aform_scalar_cold_refactor``), their
matrix-free forms (K1a's warp-per-env instance; the generic
``k1_nl22_..._scalar_cold_refactor``) and the split A-form's warp-per-env
instance.

- The keys pick the warp-per-env instances (``K1W_ONLY`` 19 / 20), as
  ``make`` builds them for the walker with those ``EngineConfig`` options;
  ``thread_per_env=True`` picks the twins.
- At B = 16 on chip_smoke.py's near-contact walker states, and with every
  base lifted 3 m, against the port's plain unit at the chip gate ``TOL``
  and against the twin's host build at ``TOL_TWIN``; near contact the
  twins' per-env median of |Δq̇| lies within three times the median by
  which the twin parts from itself when q̇ is nudged by 1e-7 (relative,
  numpy seed 0), the chip's ``rounding_floor``.
- Each against its matrix-free form (the same iteration, the sums in
  another order) at ``TOL_TWIN``, near contact and lifted.
- The A-form against the split A-form's warp-per-env build: bit for bit
  where every push-out bias is 0 (every base lifted 3 m, every joint inside
  its limits); the all-off key parts from the A-form by more than the
  plain gate near contact, so that gate would catch an instance that
  ignored the three options.

The JAX package's walker control step under both configurations is held
against their host builds in tests/test_torch_solver_options.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

TOL, TOL_TWIN = chip_smoke.TOL, chip_smoke.TOL_TWIN
B = 16
LABEL = {"aform": "k1a_aform", "all_off": "k1a_aform_scalar_cold_refactor"}
CONFIG = {kind: EngineConfig(**chip_smoke.OPTION_CONFIGS[v]) for kind, v in LABEL.items()}
SYMBOL = {"aform": "k1w_nl22_ns14_nlim21_sub4_it4_aform",
          "all_off": "k1w_nl22_ns14_nlim21_sub4_it4_aform_scalar_cold_refactor"}
ONLY = {"aform": 19, "all_off": 20}
TWIN = {"aform": "k1_nl22_ns14_nlim21_sub4_it4_aform",
        "all_off": "k1_nl22_ns14_nlim21_sub4_it4_aform_scalar_cold_refactor"}
# each one's matrix-free form: K1a's warp-per-env instance, and the generic
# instance of the all-off key with the matrix-free form
MATFREE = {"aform": EngineConfig(),
           "all_off": EngineConfig(block_pgs=False, warm_start=False, reuse_factor=False)}
KIND = pytest.mark.parametrize("kind", list(SYMBOL))
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


def _kernel(kind, thread_per_env=False, model=None):
    return engine.K1a(model or walker3d.make_model(), CONFIG[kind], thread_per_env=thread_per_env)


def _matrix_free(kind, model):
    return engine.K1a(model, MATFREE[kind])


def _split_aform(model):
    return engine.K1hSi(model, EngineConfig(**chip_smoke.OPTION_CONFIGS["k1h_si_aform"]))


@pytest.fixture(scope="module")
def libs():
    """The two warp-per-env instances, their twins, their matrix-free forms
    and the split A-form's warp-per-env instance, built by g++ side by
    side."""
    model = walker3d.make_model()
    return build_host([*(_kernel(kind, tpe, model) for kind in SYMBOL for tpe in (False, True)),
                       *(_matrix_free(kind, model) for kind in SYMBOL), _split_aform(model)])


def _states(kind, lifted=False):
    """(kernel, numpy ``(q, qd, tau, ground_z, friction)``) of chip_smoke.py's
    near-contact walker states; ``lifted`` raises every base 3 m."""
    kernel = _kernel(kind)
    arrays = [np.ascontiguousarray(x) for x in chip_smoke.near_contact_states(
        kernel.model, np.random.default_rng(95), B)]
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


@KIND
def test_keys_pick_the_warp_per_env_instance(libs, kind):
    new, old = _kernel(kind), _kernel(kind, thread_per_env=True)
    assert new.name == SYMBOL[kind] and new.instance.source == engine.SOURCE_W
    assert engine.compile_flags(new.instance) == [f"-DK1W_ONLY={ONLY[kind]}"]
    assert engine.WARP_INSTANCES[new.key] is new.instance
    assert old.name == TWIN[kind] == engine.canonical_symbol(old.key)
    assert old.instance.source == engine.SOURCE and old.instance.index is None
    assert new.key == old.key and new.variant == old.variant == LABEL[kind]
    # the walker's model as make() builds its unit under the configuration
    model = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu",
                                      config=CONFIG[kind]).model
    picked = engine.make_kernel(model, CONFIG[kind])
    assert type(picked) is engine.K1a and picked.name == new.name
    # the same table; no global workspace (the twin's holds the A-form's A)
    assert engine.layout(libs[new.name], new.name) == (new.table_host.size, 0)
    assert new.table_host.size == old.table_host.size
    assert engine.layout(libs[old.name], old.name)[1] > 0


@KIND
@LIFT
def test_k1w_matches_plain_and_thread_per_env_on_host(libs, kind, lifted):
    """Both designs against the plain unit at the chip gate, and the two
    designs against each other at ``TOL_TWIN``, within the rounding floor
    near contact."""
    new, inputs = _states(kind, lifted)
    old = _kernel(kind, thread_per_env=True, model=new.model)
    want = [t.numpy() for t in new.plain(*map(torch.as_tensor, inputs))]
    outs = run_on_host(libs[new.name], new, inputs)
    base = run_on_host(libs[old.name], old, inputs)
    for got in (outs, base):
        assert all(np.isfinite(o).all() for o in got)
        _gate(got, want, TOL)
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


@KIND
@LIFT
def test_aform_matches_its_matrix_free_form_on_host(libs, kind, lifted):
    """An A-form and its matrix-free form are the same iteration: on the
    same inputs they part only by the order of their sums, at the JAX
    package's gate between the two forms."""
    new, inputs = _states(kind, lifted)
    matfree = _matrix_free(kind, new.model)
    assert matfree.config.matfree_pgs and matfree.key == dataclasses.replace(new.key,
                                                                        matfree=True)
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, run_on_host(libs[matfree.name], matfree, inputs), TOL_TWIN)
    if not lifted:
        assert (outs[3] > 0).mean() > 0.05


def test_aform_equals_the_split_aform_where_every_bias_is_zero(libs):
    """Every base lifted 3 m and every joint 0.05 rad inside its limits: no
    contact row and no push-out bias in any substep, and the A-form gives
    the split A-form's bits; near contact the position pass moves the frame
    beyond the plain gate."""
    new, inputs = _states("aform")
    split = _split_aform(new.model)
    near = [x.copy() for x in inputs]
    lo, hi = new.model.limit_lo.numpy(), new.model.limit_hi.numpy()
    inputs[0][:, 2] += 3.0
    inputs[0][:, 7:] = np.clip(inputs[0][:, 7:], lo + 0.05, hi - 0.05)
    _, con_act, _ = engine.k1_activity(new, *map(torch.as_tensor, inputs))
    assert not con_act.any()
    outs = run_on_host(libs[new.name], new, inputs)
    for got, want in zip(outs, run_on_host(libs[split.name], split, inputs)):
        np.testing.assert_array_equal(got, want)
    assert not (outs[3] != 0).any()
    outs = run_on_host(libs[new.name], new, near)
    ref = run_on_host(libs[split.name], split, near)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL[name], (name, med)


def test_all_off_parts_from_the_aform_on_host(libs):
    """Scalar friction rows, a cold start and a factor every substep are
    another iteration: near contact the all-off instance parts from the
    A-form's by more than the plain gate in the per-env medians of q and
    q̇."""
    new, inputs = _states("all_off")
    aform = _kernel("aform", model=new.model)
    outs = run_on_host(libs[new.name], new, inputs)
    ref = run_on_host(libs[aform.name], aform, inputs)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL[name], (name, med)
