"""PyTorch port vs the JAX package: quaternion/spatial math, the walker3d
model, the model builder and the configuration (CPU).

Inputs come from numpy seeds and go to both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.core import quat as jquat
from mocca_envs_tpu.core import spatial as jspatial
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.models.schema import FIXED as JFIXED
from mocca_envs_tpu.models.schema import ModelBuilder as JBuilder
from mocca_envs_tpu.utils.config import EngineConfig as JConfig
from mocca_envs_tpu_torch import convert
from mocca_envs_tpu_torch.core import quat as tquat
from mocca_envs_tpu_torch.core import spatial as tspatial
from mocca_envs_tpu_torch.models import walker3d as twalker
from mocca_envs_tpu_torch.models.schema import FIXED as TFIXED
from mocca_envs_tpu_torch.models.schema import ModelBuilder as TBuilder
from mocca_envs_tpu_torch.utils.config import EngineConfig as TConfig

from tests import torch_workers  # noqa: F401

N = 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.standard_normal((N, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    v = rng.standard_normal((N, 3)).astype(np.float32)
    axis = rng.standard_normal((N, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rot = np.asarray(jquat.to_matrix(jnp.asarray(q)))
    inertia = np.einsum("nij,nkj->nik", m := rng.standard_normal((N, 3, 3)), m)
    return dict(
        q=q, q2=q2, v=v, axis=axis, angle=rng.uniform(-3, 3, N).astype(np.float32),
        rpy=rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32),
        omega=(3 * rng.standard_normal((N, 3))).astype(np.float32),
        raw=(2 * rng.standard_normal((N, 4))).astype(np.float32),
        rot=rot.astype(np.float32), inertia=inertia.astype(np.float32),
        diag=rng.uniform(0.01, 1.0, (N, 3)).astype(np.float32),
    )


# (module pair, function, argument names); dt enters as a python float
CASES = [
    ("quat", "normalize", ("raw",)),
    ("quat", "mul", ("q", "q2")),
    ("quat", "conj", ("q",)),
    ("quat", "rotate", ("q", "v")),
    ("quat", "inv_rotate", ("q", "v")),
    ("quat", "to_matrix", ("q",)),
    ("quat", "from_matrix", ("rot",)),
    ("quat", "from_axis_angle", ("axis", "angle")),
    ("quat", "from_rpy", ("rpy",)),
    ("quat", "to_rpy", ("q",)),
    ("quat", "from_angular_velocity", ("omega", 0.01)),
    ("quat", "integrate", ("q", "omega", 0.01)),
    ("quat", "to_xyzw", ("q",)),
    ("quat", "from_xyzw", ("q",)),
    ("spatial", "skew", ("v",)),
    ("spatial", "cross", ("v", "axis")),
    ("spatial", "transform_point", ("rot", "v", "axis")),
    ("spatial", "rotate_inertia", ("rot", "inertia")),
    ("spatial", "inertia_world", ("rot", "diag")),
]


@pytest.mark.parametrize("mod,fn,argn", CASES, ids=[c[1] for c in CASES])
def test_math_matches_jax(mod, fn, argn):
    x = _inputs()
    jmod, tmod = {"quat": (jquat, tquat), "spatial": (jspatial, tspatial)}[mod]
    jargs = [jnp.asarray(x[a]) if isinstance(a, str) else a for a in argn]
    targs = [torch.as_tensor(x[a]) if isinstance(a, str) else a for a in argn]
    if fn == "from_matrix":
        # both must give the same rotation; q and −q are one rotation
        got = getattr(tmod, fn)(*targs).numpy()
        want = np.asarray(getattr(jmod, fn)(*jargs))
        got *= np.sign(np.sum(got * want, axis=-1, keepdims=True))
    else:
        got = getattr(tmod, fn)(*targs).numpy()
        want = np.asarray(getattr(jmod, fn)(*jargs))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)


def test_quat_identities_on_port():
    """The tests/test_quat.py identities, on the port's functions."""
    x = _inputs(1)
    q, q2, v = (torch.as_tensor(x[k]) for k in ("q", "q2", "v"))
    ident = tquat.identity().expand(N, 4)
    torch.testing.assert_close(tquat.mul(ident, q), q, atol=1e-6, rtol=0)
    torch.testing.assert_close(tquat.rotate(q, v), torch.einsum("nij,nj->ni", tquat.to_matrix(q), v),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(tquat.rotate(tquat.mul(q, q2), v),
                               tquat.rotate(q, tquat.rotate(q2, v)), atol=1e-5, rtol=0)
    torch.testing.assert_close(tquat.inv_rotate(q, tquat.rotate(q, v)), v, atol=1e-5, rtol=0)
    torch.testing.assert_close(tquat.from_xyzw(tquat.to_xyzw(q)), q, atol=0, rtol=0)
    rpy = torch.tensor([0.3, -0.4, 1.2])
    torch.testing.assert_close(tquat.to_rpy(tquat.from_rpy(rpy)), rpy, atol=1e-5, rtol=0)
    # ω = 2π ẑ for 1 s in 1000 steps returns to the start
    qq = tquat.identity()
    omega = torch.tensor([0.0, 0.0, 2 * np.pi])
    for _ in range(1000):
        qq = tquat.integrate(qq, omega, 1e-3)
    assert abs(float(torch.abs(torch.sum(qq * tquat.identity()))) - 1.0) < 1e-4


def _model_fields(model) -> dict:
    return {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}


def _assert_model_equal(jmodel, tmodel):
    for name, jv in _model_fields(jmodel).items():
        tv = getattr(tmodel, name)
        if isinstance(tv, torch.Tensor):
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-7, rtol=0,
                                       err_msg=name)
        else:
            assert tuple(tv) == tuple(jv) if isinstance(jv, tuple) else tv == jv, name


def test_walker3d_model_matches_jax():
    """The port's own walker tables build the same model, array by array."""
    _assert_model_equal(jwalker.make_model(), twalker.make_model())
    assert twalker.terminal_links(twalker.make_model()) == jwalker.terminal_links(
        jwalker.make_model()
    )


def test_robot_model_from_numpy_roundtrip():
    jm = jwalker.make_model()
    fields = {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in _model_fields(jm).items()}
    _assert_model_equal(jm, convert.robot_model_from_numpy(fields))


def _build_folded(Builder, fixed):
    """A floating chain with a fixed joint to fold and rpy/quat frames."""
    b = Builder("folded", floating=True)
    b.base_inertial(3.0, (0.0, 0.0, 0.1), inertia_diag=(0.15, 0.12, 0.1))
    b.add_link("thigh", "base", joint_pos=(0.1, 0.0, -0.2), joint_rpy=(0.1, 0.0, 0.3),
               joint_axis=(0, 1, 0), mass=1.2, com=(0, 0, -0.2),
               inertia_diag=(0.02, 0.02, 0.004), limit=(-2, 2), armature=0.01)
    b.add_link("plate", "thigh", jtype=fixed, joint_pos=(0.0, 0.05, -0.3),
               joint_quat=(0.9, 0.1, 0.2, 0.3), mass=0.5, com=(0.01, 0, 0),
               inertia_diag=(0.003, 0.002, 0.001))
    b.add_link("shin", "plate", joint_pos=(0.0, 0.0, -0.1), joint_axis=(1, 0, 0),
               mass=0.8, com=(0, 0, -0.18), inertia_diag=(0.012, 0.012, 0.002),
               limit=(-2, 2), damping=0.1, power_coef=40.0)
    b.add_sphere("plate", (0.0, 0.0, -0.05), 0.03, foot="foot")
    b.add_sphere("shin", (0.0, 0.0, -0.4), 0.06, foot="foot")
    return b.build()


def test_model_builder_matches_jax():
    _assert_model_equal(_build_folded(JBuilder, JFIXED), _build_folded(TBuilder, TFIXED))


def test_engine_config_matches_jax():
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert j == t
    assert TConfig().control_dt == JConfig().control_dt


def test_walker_params_and_mirror_maps_match_jax():
    from mocca_envs_tpu.tasks import base as jbase
    from mocca_envs_tpu.tasks.walker_custom import WalkerParams as JParams
    from mocca_envs_tpu_torch.tasks import base as tbase
    from mocca_envs_tpu_torch.tasks.walker_custom import WalkerParams as TParams

    jp = JParams.default()
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    ported = convert.walker_params_from_numpy(fields)
    defaults = TParams.default()
    for name, v in fields.items():   # the defaults agree to f32 rounding
        assert getattr(ported, name) == pytest.approx(float(v), rel=1e-7), name
        assert getattr(defaults, name) == pytest.approx(float(v), rel=1e-7), name
    with pytest.raises(ValueError):
        convert.walker_params_from_numpy({**fields, "power": np.ones(3)})

    jm = jbase.mirror_spec(jwalker.make_model())
    tm = tbase.mirror_spec(twalker.make_model())
    for key in ("obs_perm", "obs_sign", "act_perm", "act_sign"):
        np.testing.assert_array_equal(tm[key].numpy(), np.asarray(jm[key]), err_msg=key)
