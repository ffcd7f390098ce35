"""PyTorch port vs the JAX package: the URDF / MJCF loaders, the exporters
and the shipped assets, on the CPU.

- ``parse_urdf`` / ``parse_mjcf`` on the six shipped files and on the four
  XML strings of tests/test_model_compilers.py (and the prismatic slider of
  tests/test_torch_prismatic.py): every static field equal, every array
  field equal to atol 1e-7;
- ``export_urdf`` / ``export_mjcf`` of every hand-built port model: the JAX
  package's text for the same model, byte for byte;
- the port's ``data/`` files equal the JAX package's byte for byte, and
  ``generate_all`` into a temporary directory writes them again;
- ``assets.load(name)`` equals the port's hand-built model within 1e-6 (the
  JAX package's own round-trip gate, tests/test_assets.py);
- ``parity.model_hash`` is the same in both packages for each asset.
"""

import os

import numpy as np
import pytest

from mocca_envs_tpu.harness import parity as jparity
from mocca_envs_tpu.models import assets as jassets
from mocca_envs_tpu.models.mjcf import parse_mjcf as jparse_mjcf
from mocca_envs_tpu.models.mjcf_export import export_mjcf as jexport_mjcf
from mocca_envs_tpu.models.urdf import parse_urdf as jparse_urdf
from mocca_envs_tpu.models.urdf_export import export_urdf as jexport_urdf
from mocca_envs_tpu.models.urdf_export import quat_to_rpy as jquat_to_rpy
from mocca_envs_tpu_torch.harness import parity
from mocca_envs_tpu_torch.models import assets
from mocca_envs_tpu_torch.models.mjcf import parse_mjcf
from mocca_envs_tpu_torch.models.mjcf_export import export_mjcf
from mocca_envs_tpu_torch.models.schema import ARRAY_FIELDS, STATIC_FIELDS
from mocca_envs_tpu_torch.models.urdf import parse_urdf
from mocca_envs_tpu_torch.models.urdf_export import export_urdf, quat_to_rpy

from tests import torch_workers  # noqa: F401
from tests.test_model_compilers import MJCF_HOPPER, MJCF_ROTATED, PENDULUM_URDF, WALKER_URDF
from tests.test_torch_prismatic import SLIDER_URDF, SLIDER_MJCF

ATOL = 1e-7


def assert_models_equal(port, ref, atol=ATOL):
    """Every static field equal; every array field of the same shape and
    within ``atol`` (the port's index arrays are int64, the JAX int32)."""
    for f in STATIC_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    for f in ARRAY_FIELDS:
        a = getattr(port, f).cpu().numpy().astype(np.float64)
        b = np.asarray(getattr(ref, f), dtype=np.float64)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)


XML_CASES = {
    "pendulum_urdf": (PENDULUM_URDF, "urdf", {"floating": False}),
    "walker_fixed_joint_urdf": (WALKER_URDF, "urdf", {"floating": True}),
    "slider_urdf": (SLIDER_URDF, "urdf", {}),
    "hopper_mjcf": (MJCF_HOPPER, "mjcf", {}),
    "rotated_mjcf": (MJCF_ROTATED, "mjcf", {}),
    "slider_mjcf": (SLIDER_MJCF, "mjcf", {}),
}


@pytest.mark.parametrize("case", list(XML_CASES))
def test_parsers_match_jax_on_xml_strings(case):
    text, kind, kw = XML_CASES[case]
    if kind == "urdf":
        port, ref = parse_urdf(text, **kw), jparse_urdf(text, **kw)
    else:
        port, ref = parse_mjcf(text, **kw), jparse_mjcf(text, **kw)
    assert_models_equal(port, ref)


@pytest.mark.parametrize("name", assets.names())
def test_parse_urdf_matches_jax_on_shipped_files(name):
    path = assets.asset_path(name)
    for kw in ({}, {"foot_link_keywords": ()}):
        assert_models_equal(parse_urdf(path, **kw), jparse_urdf(path, **kw))


def test_parse_mjcf_matches_jax_on_the_shipped_walker():
    path = os.path.join(assets.DATA_DIR, "walker3d.xml")
    assert_models_equal(parse_mjcf(path), jparse_mjcf(path))


def test_parsers_reject_what_jax_rejects():
    for text in ("<mujoco/>", "<robot name='x'><link name='a'/><link name='b'/></robot>"):
        with pytest.raises(ValueError):
            parse_urdf(text)
        with pytest.raises(ValueError):
            jparse_urdf(text)
    with pytest.raises(ValueError, match="worldbody"):
        parse_mjcf("<mujoco/>")


@pytest.mark.parametrize("name", assets.names())
def test_exporters_match_jax_byte_for_byte(name):
    port_model = assets._families()[name]()
    ref_model = jassets._families()[name]()
    assert export_urdf(port_model, name=name) == jexport_urdf(ref_model, name=name)
    assert export_mjcf(port_model, name=name) == jexport_mjcf(ref_model, name=name)
    assert export_urdf(port_model) == jexport_urdf(ref_model)


def test_exporters_on_rigs_and_quat_to_rpy():
    """The fixed-base pendulum and the MJCF hopper, exported by both
    packages from their own parse: the same text. The slider's joint frame
    (rpy 0.1 rounded to a float32 quaternion) misses ``quat_to_rpy``'s 1e-9
    round-trip check in both: the same refusal. ``quat_to_rpy`` gives the
    same rpy on seeded quaternions, the gimbal case included."""
    for port, ref in ((parse_urdf(PENDULUM_URDF, floating=False),
                       jparse_urdf(PENDULUM_URDF, floating=False)),
                      (parse_mjcf(MJCF_HOPPER), jparse_mjcf(MJCF_HOPPER))):
        assert export_urdf(port) == jexport_urdf(ref)
        assert export_mjcf(port) == jexport_mjcf(ref)
    for export in (export_urdf, jexport_urdf):
        with pytest.raises(ValueError, match="round-trip"):
            export(jparse_urdf(SLIDER_URDF) if export is jexport_urdf else parse_urdf(SLIDER_URDF))
    rng = np.random.default_rng(0)
    quats = rng.standard_normal((16, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    quats = np.concatenate([quats, [[np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0]]])
    for q in quats:
        np.testing.assert_array_equal(quat_to_rpy(q), jquat_to_rpy(q))


def test_shipped_data_equals_jax_and_regenerates(tmp_path):
    shipped = sorted(os.listdir(assets.DATA_DIR))
    assert shipped == sorted(os.listdir(jassets.DATA_DIR))
    assert shipped == sorted([f"{n}.urdf" for n in assets.names()] + ["walker3d.xml"])
    for fname in shipped:
        with open(os.path.join(assets.DATA_DIR, fname), "rb") as f:
            mine = f.read()
        with open(os.path.join(jassets.DATA_DIR, fname), "rb") as f:
            assert mine == f.read(), fname
    written = assets.generate_all(str(tmp_path))
    assert sorted(os.path.basename(p) for p in written) == shipped
    for p in written:
        with open(p, "rb") as f, open(os.path.join(assets.DATA_DIR, os.path.basename(p)),
                                       "rb") as g:
            assert f.read() == g.read(), p


@pytest.mark.parametrize("name", assets.names())
def test_load_matches_handbuilt_and_jax_hash(name):
    loaded = assets.load(name, device="cpu")
    assert loaded.device.type == "cpu"
    assert_models_equal(loaded, jassets.load(name))
    hand = assets._families()[name]()
    for f in STATIC_FIELDS:
        assert getattr(hand, f) == getattr(loaded, f), f
    for f in ARRAY_FIELDS:
        a, b = getattr(hand, f).double(), getattr(loaded, f).double()
        assert a.shape == b.shape, f
        assert float((a - b).abs().max()) <= 1e-6, f
    assert parity.model_hash(loaded) == jparity.model_hash(jassets.load(name))
    assert parity.model_hash(hand) == jparity.model_hash(jassets._families()[name]())


def test_load_defaults_to_the_card(monkeypatch):
    """``load(name)`` without a device means the CUDA card, and raises where
    there is none rather than running on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        assets.load("walker3d")
