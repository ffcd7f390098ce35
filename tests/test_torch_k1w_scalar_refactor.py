"""The walker's scalar-friction key and its factor-every-substep key
redesigned for Hopper (``csrc/engine_k1w.cu``, one warp per env): the
walker's frame on the plane in the matrix-free form with ``block_pgs=False``
(a contact's t1 then t2 row, each clamped alone) and with
``reuse_factor=False`` (a CRBA and factor in every substep), on the CPU. The
warp-per-env source's per-env code is built by g++ under
``-DK1W_HOST_CHECK`` (lane width 1, the collectives identities) and run as a
loop over envs, beside the thread-per-env twins (``-DK1_HOST_CHECK``: the
generic ``engine_k1.cu`` instances ``k1_nl22_..._scalar`` and
``k1_nl22_..._refactor``), their A-form twins (the generic
``k1_nl22_..._aform_scalar`` and ``k1_nl22_..._aform_refactor``) and K1a's
warp-per-env instance.

- The keys pick the warp-per-env instances (``K1W_ONLY`` 21 / 22), as
  ``make`` builds them for the walker with those ``EngineConfig`` options;
  ``thread_per_env=True`` picks the twins.
- At B = 16 on chip_smoke.py's near-contact walker states, and with every
  base lifted 3 m, against the port's plain unit at the chip gate ``TOL``
  and against the twin's host build at ``TOL_TWIN`` (per-env medians, the
  largest env within ten times); near contact the twins' per-env median of
  |Δq̇| lies within three times the median by which the twin parts from
  itself when q̇ is nudged by 1e-7 (relative, numpy seed 0), the chip's
  ``rounding_floor``.
- Each against its A-form twin (the same iteration, written independently,
  the sums in another order) at ``TOL_TWIN``, near contact and lifted.
- Each parts from K1a's warp-per-env build by more than the plain gate near
  contact in the per-env medians of q and q̇, so that gate would catch an
  instance that ignored its option.

The JAX package's walker control step under both configurations is held
against their host builds in tests/test_torch_solver_options.py.
"""

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
LABEL = {"scalar": "k1a_scalar", "refactor": "k1a_refactor"}
CONFIG = {kind: EngineConfig(**chip_smoke.OPTION_CONFIGS[v]) for kind, v in LABEL.items()}
SYMBOL = {kind: f"k1w_nl22_ns14_nlim21_sub4_it4_{kind}" for kind in LABEL}
ONLY = {"scalar": 21, "refactor": 22}
TWIN = {kind: f"k1_nl22_ns14_nlim21_sub4_it4_{kind}" for kind in LABEL}
AFORM = {kind: f"k1_nl22_ns14_nlim21_sub4_it4_aform_{kind}" for kind in LABEL}
KIND = pytest.mark.parametrize("kind", list(SYMBOL))
LIFT = pytest.mark.parametrize("lifted", [False, True], ids=["near_contact", "lifted"])


def _kernel(kind, thread_per_env=False, model=None):
    return engine.K1a(model or walker3d.make_model(), CONFIG[kind], thread_per_env=thread_per_env)


def _aform(kind, model):
    return engine.K1a(model, EngineConfig(**chip_smoke.OPTION_CONFIGS[LABEL[kind]],
                                          matfree_pgs=False), thread_per_env=True)


@pytest.fixture(scope="module")
def libs():
    """The two warp-per-env instances, their twins, their A-form twins and
    K1a's warp-per-env instance, built by g++ side by side."""
    model = walker3d.make_model()
    return build_host([*(_kernel(kind, tpe, model) for kind in SYMBOL for tpe in (False, True)),
                       *(_aform(kind, model) for kind in SYMBOL),
                       engine.K1a(model, EngineConfig())])


def _states(kind, lifted=False):
    """(kernel, numpy ``(q, qd, tau, ground_z, friction)``) of chip_smoke.py's
    near-contact walker states; ``lifted`` raises every base 3 m."""
    kernel = _kernel(kind)
    arrays = [np.ascontiguousarray(x) for x in chip_smoke.near_contact_states(
        kernel.model, np.random.default_rng(96), B)]
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
    assert new.config.matfree_pgs and new.key.matfree
    assert old.name == TWIN[kind] == engine.canonical_symbol(old.key)
    assert old.instance.source == engine.SOURCE and old.instance.index is None
    assert new.key == old.key and new.variant == old.variant == LABEL[kind]
    # the A-form twin keeps its generic engine_k1.cu instance
    aform = _aform(kind, new.model)
    assert aform.name == AFORM[kind] and aform.instance.source == engine.SOURCE
    # the walker's model as make() builds its unit under the configuration
    model = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu",
                                      config=CONFIG[kind]).model
    picked = engine.make_kernel(model, CONFIG[kind])
    assert type(picked) is engine.K1a and picked.name == new.name
    # the same table; no global workspace (the twin's holds W, λ and z)
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
def test_k1w_matches_its_aform_twin_on_host(libs, kind, lifted):
    """The matrix-free form and the A-form are the same iteration: on the
    same inputs the new instance and the generic A-form instance of its key
    part only by the order of their sums, at the JAX package's gate between
    the two forms."""
    new, inputs = _states(kind, lifted)
    aform = _aform(kind, new.model)
    assert not aform.config.matfree_pgs and aform.variant == f"k1a_aform_{kind}"
    outs = run_on_host(libs[new.name], new, inputs)
    _gate(outs, run_on_host(libs[aform.name], aform, inputs), TOL_TWIN)
    if not lifted:
        assert (outs[3] > 0).mean() > 0.05


@KIND
def test_option_parts_from_k1a_on_host(libs, kind):
    """Scalar friction rows and a factor every substep are each another
    iteration: near contact the new instance parts from K1a's by more than
    the plain gate in the per-env medians of q and q̇."""
    new, inputs = _states(kind)
    k1a = engine.K1a(new.model, EngineConfig())
    assert k1a.name == "k1w_nl22_ns14_nlim21_sub4_it4"
    outs = run_on_host(libs[new.name], new, inputs)
    ref = run_on_host(libs[k1a.name], k1a, inputs)
    for name, i in (("q", 0), ("qd", 1)):
        med = float(np.median(np.abs(outs[i] - ref[i]).max(axis=1)))
        assert med > TOL[name], (name, med)
