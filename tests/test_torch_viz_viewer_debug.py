"""PyTorch port vs the JAX package: the trajectory dump, the viewer and the
debug tools, on the CPU.

- ``dump_trajectory`` on 5 walker frames gives the JAX package's document
  (every list equal; numbers within 1e-4, a rounding flip at the 4th
  decimal), markers included, and ``link_poses`` its poses;
- ``scene_to_desc`` for a flat, a stones, a bars, a heightfield and a mesh
  scene: the JAX document of the same scene;
- ``export_html`` round-trips the embedded JSON (as tests/test_viewer.py);
  the viewer CLI with ``--dump`` and with ``--env --steps 5`` on the CPU;
- ``finite_fraction`` equals the JAX function's on the same tree;
- ``validate_state`` and ``nan_debug`` raise, then let finite work through.
"""

import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocca_envs_tpu.harness import viz as jviz
from mocca_envs_tpu.models import walker3d as jwalker
from mocca_envs_tpu.terrain import scene as jscene
from mocca_envs_tpu.utils import debug as jdebug
from mocca_envs_tpu_torch.harness import viewer, viz
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.terrain import scene as tscene
from mocca_envs_tpu_torch.utils import debug

from tests import torch_workers  # noqa: F401


def assert_docs_close(a, b, atol=1e-4, path="doc"):
    """The same structure, keys and lengths; numbers within ``atol``."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            assert_docs_close(a[k], b[k], atol, f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_docs_close(x, y, atol, f"{path}[{i}]")
    elif isinstance(b, float):
        assert type(a) is float and abs(a - b) <= atol, (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _walker_frames(T=5, seed=0):
    rng = np.random.default_rng(seed)
    m = walker3d.make_model()
    qs = np.zeros((T, m.nq), np.float32)
    qs[:, 0:2] = rng.uniform(-1, 1, (T, 2))
    qs[:, 2] = 0.9
    qs[:, 3:7] = np.array([1.0, 0, 0, 0]) + 0.1 * rng.standard_normal((T, 4))
    qs[:, 3:7] /= np.linalg.norm(qs[:, 3:7], axis=1, keepdims=True)
    qs[:, 7:] = 0.4 * rng.standard_normal((T, m.nj))
    return qs


def test_dump_trajectory_matches_jax(tmp_path):
    qs = _walker_frames()
    markers = np.random.default_rng(1).standard_normal((5, 2, 3)).astype(np.float32)
    desc = [{"name": "target", "radius": 0.1}, {"name": "stone", "radius": 0.05}]
    for kw in ({}, {"every": 2, "markers": markers, "marker_desc": desc},
               {"markers": markers}):
        mine, ref = tmp_path / "mine.json", tmp_path / "ref.json"
        viz.dump_trajectory(walker3d.make_model(), qs, str(mine), scene_desc={"ground_z": 0.0},
                            **kw)
        jviz.dump_trajectory(jwalker.make_model(), qs, str(ref), scene_desc={"ground_z": 0.0},
                             **kw)
        a, b = json.loads(mine.read_text()), json.loads(ref.read_text())
        assert_docs_close(a, b)
        assert len(a["frames"]) == len(range(0, 5, kw.get("every", 1)))


def test_link_poses_match_jax():
    q = _walker_frames(1)[0]
    pos, rot = viz.link_poses(walker3d.make_model(), q)
    jpos, jrot = jviz.link_poses(jwalker.make_model(), jnp.asarray(q))
    np.testing.assert_allclose(pos, np.asarray(jpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rot, np.asarray(jrot), rtol=0, atol=1e-5)
    qd = np.random.default_rng(2).standard_normal(walker3d.make_model().nv).astype(np.float32)
    pos2, _ = viz.link_poses(walker3d.make_model(), q, qd)
    np.testing.assert_array_equal(pos2, pos)


def _scenes():
    """(port scene of 2 slots, JAX scene) pairs from the same numpy data;
    slot 0 of the port's scene holds the data, slot 1 zeros."""
    rng = np.random.default_rng(5)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    two = lambda x: torch.as_tensor(np.stack([x, np.zeros_like(x)]))  # noqa: E731
    pos, half = f32(6, 3), np.abs(f32(6, 3)) + 0.1
    quat = f32(6, 4)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    active = (rng.uniform(size=6) > 0.3).astype(np.float32)
    a, b, r = f32(4, 3), f32(4, 3), np.abs(f32(4)) * 0.05
    hf, xy0, cell = f32(9, 9), f32(2), np.float32(0.25)
    stairs = tscene.broadcast_scene(tscene.stairs_trimesh(n_steps=3, start_x=0.6), 2)
    return {
        "flat": (dataclasses.replace(tscene.flat(2), ground_z=torch.tensor([0.3, 0.0])),
                 jscene.flat(ground_z=0.3)),
        "stones": (tscene.with_stones(two(pos), two(quat), two(half), two(active)),
                   jscene.with_stones(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(half),
                                      jnp.asarray(active))),
        "bars": (tscene.with_bars(two(a), two(b), two(r)),
                 jscene.Scene(has_ground=True, has_bars=True, ground_z=jnp.asarray(-8.0),
                              bar_a=jnp.asarray(a), bar_b=jnp.asarray(b), bar_r=jnp.asarray(r),
                              bar_active=jnp.ones(4))),
        "heightfield": (dataclasses.replace(
            tscene.flat(2, ground_z=tscene.NO_GROUND_Z), hf_height=two(hf), hf_xy0=two(xy0),
            hf_cell=torch.tensor([cell, 0.5])),
            jscene.Scene(has_ground=False, has_hf=True, hf_height=jnp.asarray(hf),
                         hf_xy0=jnp.asarray(xy0), hf_cell=jnp.asarray(cell))),
        "mesh": (stairs, jscene.stairs_trimesh(n_steps=3, start_x=0.6)),
    }


@pytest.mark.parametrize("kind", ["flat", "stones", "bars", "heightfield", "mesh"])
def test_scene_to_desc_matches_jax(kind):
    mine, ref = _scenes()[kind]
    desc = viz.scene_to_desc(mine)
    want = jviz.scene_to_desc(ref)
    assert json.dumps(desc) == json.dumps(want)
    assert ("ground_z" in desc) == (kind != "heightfield")


@pytest.fixture(scope="module")
def stairs_doc():
    return viewer.record_rollout_doc("Walker3DStairsEnv", steps=5, device="cpu")


def test_record_rollout_doc_and_export_html(stairs_doc, tmp_path):
    d = stairs_doc
    assert len(d["frames"]) == len(d["sphere_frames"]) == 6
    assert len(d["frames"][0]) == len(d["link_names"]) == len(d["parent"])
    assert len(d["scene"]["tris"]["a"]) == 24
    assert np.isfinite(np.asarray(d["sphere_frames"])).all()
    out = viewer.export_html(d, str(tmp_path / "sub" / "v.html"))
    html = open(out).read()
    assert "__DOC_JSON__" not in html
    doc = json.loads(re.search(r"const DOC = (\{.*?\});\n", html, re.S).group(1))
    assert doc == json.loads(json.dumps(d))
    for token in ("requestAnimationFrame", "keydown", "mousedown", "wheel", "scrub", "follow",
                  "Space", "ArrowLeft"):
        assert token in html, token
    script = html.split("<script>")[1].split("</script>")[0]
    script = re.sub(r"'[^']*'|\"[^\"]*\"|`[^`]*`", "", script)
    for o, c in (("{", "}"), ("(", ")"), ("[", "]")):
        assert script.count(o) == script.count(c), o


def test_record_rollout_doc_with_a_policy():
    calls = []

    def policy(obs):
        calls.append(obs.shape)
        return np.zeros(21, np.float32)

    d = viewer.record_rollout_doc("Walker3DCustomEnv", steps=3, every=2, policy=policy,
                                  device="cpu")
    assert len(calls) == 3 and len(d["frames"]) == 2 and d["scene"] == {"ground_z": 0.0}


def test_viewer_cli(tmp_path, stairs_doc, capsys):
    dump = tmp_path / "traj.json"
    dump.write_text(json.dumps(stairs_doc))
    viewer.main(["--dump", str(dump), "--out", str(tmp_path / "a.html")])
    viewer.main(["--env", "Walker3DCustomEnv", "--steps", "5", "--out",
                 str(tmp_path / "b.html")], device="cpu")
    out = capsys.readouterr().out
    assert "wrote" in out and (tmp_path / "a.html").exists()
    html = (tmp_path / "b.html").read_text()
    doc = json.loads(re.search(r"const DOC = (\{.*?\});\n", html, re.S).group(1))
    assert len(doc["frames"]) == 6
    with pytest.raises(SystemExit):
        viewer.main(["--out", str(tmp_path / "c.html")])


def test_finite_fraction_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    a[0, 1], a[2, 3] = np.nan, np.inf
    b = rng.standard_normal(7).astype(np.float32)
    b[4] = -np.inf
    ints = np.arange(6, dtype=np.int32)
    mine = debug.finite_fraction({"a": torch.as_tensor(a), "n": [torch.as_tensor(b), None],
                                  "i": torch.as_tensor(ints)})
    ref = jdebug.finite_fraction({"a": jnp.asarray(a), "n": [jnp.asarray(b), None],
                                  "i": jnp.asarray(ints)})
    assert mine.dtype == torch.float32
    assert float(mine) == float(ref) == float(np.float32(24) / np.float32(27))
    assert float(debug.finite_fraction({"i": torch.as_tensor(ints)})) == 0.0


def test_validate_state_names_the_field():
    from mocca_envs_tpu_torch import make

    env = make("Walker3DCustomEnv", device="cpu")
    state = env.init(torch.Generator().manual_seed(0), 3)
    assert debug.validate_state(state) is state
    assert float(debug.finite_fraction(state)) == 1.0
    state.task.target[2, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"non-finite values in state\.task\.target"):
        debug.validate_state(state)
    state.qd[0, 0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"in walker\.qd$"):
        debug.validate_state(state, "walker")


def test_nan_debug_raises_then_restores():
    x = torch.zeros(3)
    with debug.nan_debug():
        y = torch.ones(3) * 2.0   # finite work runs
        with pytest.raises(FloatingPointError, match="div"):
            x / x
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
    assert torch.equal(y, torch.full((3,), 2.0))
    assert bool(torch.isnan(x / x).all())   # off again after the block
