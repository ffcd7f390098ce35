"""The port's kernel wrapper and entry points: no JAX, no silent CPU path.

- the package imports and steps on the CPU with JAX made unimportable, and
  no module of it (or chip_smoke.py) imports JAX or the JAX package;
- ``make()`` / ``BatchedEnv`` with no device mean the CUDA card and raise
  where there is none;
- the CPU path never launches the kernel; the kernel's launch refuses CPU
  tensors and configurations it has no instantiation for;
- the bound's operation count follows the rows these inputs make active;
- the kernel source's per-env arithmetic, compiled for the host, agrees
  with the plain version;
- on a card: the kernel agrees with its plain version (skips elsewhere).
"""

import ast
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mocca_envs_tpu_torch
from mocca_envs_tpu_torch.models import walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.utils.config import EngineConfig

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mocca_envs_tpu"}
TOL = {"q": 2e-4, "qd": 5e-3, "depth": 2e-4, "nimp": 5e-3}


def _near_contact(B, seed):
    rng = np.random.default_rng(seed)
    q = np.zeros((B, 28), np.float32)
    q[:, 2] = 0.9 + 0.05 * rng.standard_normal(B)
    q[:, 3:7] = np.array([1.0, 0.0, 0.0, 0.0]) + 0.03 * rng.standard_normal((B, 4))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] = 0.1 * rng.standard_normal((B, 21))
    qd = (0.3 * rng.standard_normal((B, 27))).astype(np.float32)
    tau = (rng.uniform(-1, 1, (B, 21)) * walker3d.model_fields()["power_coef"]).astype(np.float32)
    return q, qd, tau, np.zeros(B, np.float32), np.full(B, 0.8, np.float32)


def _gate_medians(got, want):
    for name, g, w in zip(("q", "qd", "depth", "nimp"), got, want):
        per_env = np.abs(np.asarray(g) - np.asarray(w)).max(axis=1)
        assert np.median(per_env) <= TOL[name], (name, float(np.median(per_env)))
        assert per_env.max() <= 10 * TOL[name], (name, float(per_env.max()))


def test_port_runs_with_jax_unimportable():
    code = """
import sys
for m in ("jax", "jaxlib", "flax", "optax", "orbax", "mocca_envs_tpu"):
    sys.modules[m] = None
import torch
import mocca_envs_tpu_torch as P
from mocca_envs_tpu_torch import convert  # noqa: F401
from mocca_envs_tpu_torch.ops.cuda import engine  # noqa: F401
env = P.make("Walker3DCustomEnv-v0", device="cpu")
batch = P.BatchedEnv(env, 2, seed=0, device="cpu")
tr = batch.step(batch.init(), torch.zeros(2, env.act_dim))
assert tr.obs.shape == (2, env.obs_dim) and bool(torch.isfinite(tr.obs).all())
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "mocca_envs_tpu")]
assert not loaded, loaded
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_sources_import_no_jax():
    files = sorted((REPO / "mocca_envs_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_no_device_means_cuda():
    cpu_env = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu")
    if torch.cuda.is_available():
        assert mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0").device.type == "cuda"
        with pytest.raises(ValueError):
            mocca_envs_tpu_torch.BatchedEnv(cpu_env, 2)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mocca_envs_tpu_torch.BatchedEnv(cpu_env, 2)


def test_cpu_path_never_launches_the_kernel():
    env = mocca_envs_tpu_torch.make("Walker3DCustomEnv-v0", device="cpu")
    batch = mocca_envs_tpu_torch.BatchedEnv(env, 3, seed=1, device="cpu")
    engine.LAUNCHES.clear()
    state = batch.init()
    for _ in range(3):
        state = batch.step(state, torch.rand(3, env.act_dim) * 2 - 1).state
    assert engine.LAUNCHES["k1a"] == 0
    # the kernel's launch refuses CPU tensors (no silent CPU path); the
    # plain version runs on them, uncounted
    k1a = engine.K1a(walker3d.make_model(), EngineConfig())
    args = [torch.as_tensor(x) for x in _near_contact(4, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        k1a.launch(*args)
    assert all(bool(torch.isfinite(x).all()) for x in k1a.plain(*args))
    assert engine.LAUNCHES["k1a"] == 0


@pytest.mark.parametrize("change", [
    {"warm_start": False}, {"matfree_pgs": False}, {"reuse_factor": False},
    {"block_pgs": False}, {"split_impulse": True}, {"solver_iters": 8},
    {"sim_substeps": 2},
], ids=lambda c: next(iter(c)))
def test_k1a_refuses_what_it_has_no_instantiation_for(change):
    with pytest.raises(NotImplementedError):
        engine.K1a(walker3d.make_model(), EngineConfig(**change))


def test_k1a_refuses_other_model_sizes():
    from mocca_envs_tpu_torch.models.schema import ModelBuilder

    b = ModelBuilder("hopper", floating=True)
    b.base_inertial(5.0, (0, 0, 0), inertia_diag=(0.1, 0.1, 0.1))
    b.add_link("leg", "base", joint_pos=(0, 0, -0.1), joint_axis=(0, 1, 0), mass=1.0,
               com=(0, 0, -0.25), inertia_diag=(0.02, 0.02, 0.002), limit=(-1.5, 1.5))
    b.add_sphere("leg", (0, 0, -0.5), 0.05, foot="foot")
    with pytest.raises(NotImplementedError, match="no K1a instantiation"):
        engine.K1a(b.build(), EngineConfig())


def test_k1a_flops_counts_only_the_active_rows():
    model, config = walker3d.make_model(), EngineConfig()
    args = [torch.as_tensor(x) for x in _near_contact(16, 3)]
    lim_act, con_act = engine.k1a_activity(model, config, *args)
    S = config.sim_substeps
    assert lim_act.shape == (S, 16, 21) and con_act.shape == (S, 16, 14)
    # the last substep's contact mask is the one the plain frame reports
    depth = engine.K1a(model, config).plain(*args)[2]
    assert torch.equal(con_act[-1], depth > -config.contact_margin)
    assert 0 < int(con_act.sum()) < con_act.numel()
    none = engine.k1a_flops(model, config, torch.zeros_like(lim_act), torch.zeros_like(con_act))
    need = engine.k1a_flops(model, config, lim_act, con_act)
    full = engine.k1a_flops(model, config, torch.ones_like(lim_act), torch.ones_like(con_act))
    assert none < need < full
    # one more active contact in one substep adds that contact's work only
    extra = con_act.clone()
    s, b, k = (~extra).nonzero()[0].tolist()
    extra[s, b, k] = True
    grown = engine.k1a_flops(model, config, lim_act, extra)
    assert 0 < grown - need < (full - none) / (S * 16)


def test_k1a_source_arithmetic_on_host(tmp_path):
    """The kernel's per-env code (csrc/engine_k1a.cu) built by the host C++
    compiler, run as a loop over envs, against the plain version."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's host check")
    lib_path = tmp_path / "k1a_host.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-x", "c++", "-DK1A_HOST_CHECK", "-shared",
                    "-fPIC", "-o", str(lib_path), str(engine.SOURCE)], check=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    k1a = engine.K1a(walker3d.make_model(), EngineConfig())
    table_size, ws_per_env = engine.layout(lib, k1a.name)
    assert table_size == k1a.table_host.size
    B = 32
    inputs = [np.ascontiguousarray(x) for x in _near_contact(B, 5)]
    outs = [np.zeros((B, 28), np.float32), np.zeros((B, 27), np.float32),
            np.zeros((B, 14), np.float32), np.zeros((B, 14), np.float32)]
    ws = np.zeros(ws_per_env * B, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = getattr(lib, k1a.name + "_host")
    fn.restype = ctypes.c_int
    err = fn(*map(ptr, inputs), *map(ptr, outs), ptr(k1a.table_host),
             ctypes.c_int(table_size), ptr(ws), ctypes.c_int(B))
    assert err == 0
    want = [t.numpy() for t in k1a.plain(*map(torch.as_tensor, inputs))]
    _gate_medians(outs, want)
    assert (want[3] > 0).mean() > 0.1   # contacts carry load


@pytest.mark.cuda
def test_k1a_kernel_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1a kernel has no CPU mode")
    model = walker3d.make_model("cuda")
    k1a = engine.K1a(model, EngineConfig())
    args = [torch.as_tensor(x, device="cuda") for x in _near_contact(1024, 7)]
    before = engine.LAUNCHES["k1a"]
    got = k1a.launch(*args)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["k1a"] == before + 1
    want = k1a.plain(*args)
    _gate_medians([g.cpu().numpy() for g in got], [w.cpu().numpy() for w in want])
    with pytest.raises(ValueError, match="contiguous"):
        k1a.launch(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        k1a.launch(args[0], args[1].cpu(), *args[2:])
