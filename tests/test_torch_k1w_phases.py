"""The clocked warp-per-env K1 kernel (``k1w_kernel<C, true>``,
``<symbol>_launch_phases``) and the program's spans, with their one gate,
``harness/profile.py::tracing``.

- On the CPU, on the benchmark cells' two keys (the walker's K1a and
  Cassie's K1e), the clocked host entry (``<symbol>_host_phases``, g++ under
  ``-DK1W_HOST_CHECK``) equals the shipped one bit for bit, and each env's
  phase visits per call follow the key: K1a 4 of each per-substep phase, 1
  factor, 1 io; K1e 20 and 10 factors. There a stamp reads a per-env counter
  that each stamp advances by one, so each phase's cycles count the stamps
  that closed in it, the untallied ones (the state in, the anchors, the PD
  torque) included, and a second call adds to the first.
- With no profiler recording, ``BatchedEnv.step`` dispatches no
  ``profiler.*`` op and no K1 launch is clocked; under ``torch.profiler``
  each step is one ``env.step`` span that holds every op of the step.
- On a card (``-m cuda``), at B = 4096 on the same keys, the clocked kernel's
  outputs equal the shipped kernel's bit for bit and its visits follow the
  key.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from mocca_envs_tpu_torch import BatchedEnv, make
from mocca_envs_tpu_torch.models import cassie, walker3d
from mocca_envs_tpu_torch.ops.cuda import engine
from mocca_envs_tpu_torch.tasks.cassie_task import CASSIE_CONFIG
from mocca_envs_tpu_torch.utils.config import EngineConfig

from tests import torch_workers  # noqa: F401
from tests.torch_k1_host import build_host, run_on_host

KEYS = ("k1a", "k1e")
KEY = pytest.mark.parametrize("key", KEYS)
SUBSTEP_PHASES = ("fk", "narrowphase", "bias", "rows", "pgs", "integrate")


def _kernel(key):
    """The cells' kernels: the walker's K1a at the shipped options, Cassie's
    K1e (its rods, PD at 10 llc frames)."""
    if key == "k1a":
        return engine.K1a(walker3d.make_model(), EngineConfig())
    model = cassie.make_model()
    return engine.K1e(model, CASSIE_CONFIG, cassie.constraints(), pd_mode=True,
                      extra_damping=model.actuated * model.kd)


def _states(key, batch, seed=3):
    """chip_smoke.py's states of the key: walkers near contact, Cassies
    near the stand pose."""
    rng = np.random.default_rng(seed)
    if key == "k1a":
        arrays = chip_smoke.near_contact_states(walker3d.make_model(), rng, batch)
    else:
        model = cassie.make_model()
        arrays = chip_smoke.cassie_states(model, cassie.stand_q(model), cassie.initial_z(), rng,
                                          False, batch)
    return [np.ascontiguousarray(x) for x in arrays]


def _visits(kernel) -> dict:
    """Each phase's visits per env and call, from the key."""
    k = kernel.key
    substeps = k.llc * k.substeps
    factors = k.llc * (1 if k.reuse else k.substeps)
    return {"io": 1, "factor": factors, **dict.fromkeys(SUBSTEP_PHASES, substeps)}


@pytest.fixture(scope="module")
def libs():
    """The two instances built by g++, side by side."""
    return build_host([_kernel(key) for key in KEYS])


@KEY
def test_clocked_host_entry_equals_shipped_and_counts_the_key(libs, key):
    kernel = _kernel(key)
    inputs = _states(key, 8)
    lib = libs[kernel.name]
    shipped = run_on_host(lib, kernel, inputs)
    clocks = np.zeros((8, len(engine.PHASES), 2), np.int64)
    clocked = run_on_host(lib, kernel, inputs, clocks=clocks)
    for name, a, b in zip(("q", "qd", "depth", "nimp"), shipped, clocked):
        np.testing.assert_array_equal(a, b, err_msg=name)
    visits = _visits(kernel)
    k = kernel.key
    # the stamps that close no visit: the state in (io), each substep's
    # anchors (fk) and, in PD mode, each frame's torque (bias)
    untallied = {"io": 1, "fk": k.llc * k.substeps, "bias": k.llc if k.pd else 0}
    for env in range(8):
        got = dict(zip(engine.PHASES, clocks[env].tolist()))
        assert {p: v for p, (_, v) in got.items()} == visits, (key, env, got)
        assert {p: c for p, (c, _) in got.items()} == {
            p: visits[p] + untallied.get(p, 0) for p in engine.PHASES}, (key, env, got)
    # a second call adds into the same counts
    run_on_host(lib, kernel, inputs, clocks=clocks)
    assert (clocks[:, :, 1] == 2 * np.array([visits[p] for p in engine.PHASES])).all()


def _walker_batch():
    env = make("Walker3DCustomEnv-v0", device="cpu")
    batch = BatchedEnv(env, 4, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(5)
    actions = [torch.rand((4, env.act_dim), generator=gen) * 2 - 1 for _ in range(3)]
    return batch, batch.init(), actions


def test_no_profiler_no_span_op_and_no_clocked_launch():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Names(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    batch, state, actions = _walker_batch()
    engine.PHASE_CLOCKS.clear()
    with Names() as seen:
        batch.step(state, actions[0])
    assert seen.names and not [n for n in seen.names if n.startswith("profiler.")]
    assert engine.k1_phases() == {}


def test_profiled_step_is_one_span_holding_its_ops(tmp_path):
    batch, state, actions = _walker_batch()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for a in actions:
            state = batch.step(state, a).state
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == "env.step")
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "cpu_op"]
    assert len(spans) == len(actions) and ops
    held = [sum(a <= s and t <= b for s, t in ops) for a, b in spans]
    assert min(held) > 0 and sum(held) == len(ops), held
    # the CPU runs the plain path: nothing to clock
    assert engine.k1_phases() == {}


@pytest.mark.cuda
@KEY
def test_clocked_kernel_equals_shipped_on_cuda(key):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    kernel = _kernel(key)
    B = 4096
    args = [torch.as_tensor(x, device="cuda") for x in _states(key, B)]
    engine.PHASE_CLOCKS.clear()
    launches = engine.INSTANCE_LAUNCHES[kernel.name]
    shipped = kernel.launch(*args)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        clocked = kernel.launch(*args)
        torch.cuda.synchronize()
    assert engine.INSTANCE_LAUNCHES[kernel.name] == launches + 2
    for name, a, b in zip(("q", "qd", "depth", "nimp"), shipped, clocked):
        assert torch.equal(a, b), name
    phases = engine.k1_phases()
    assert list(phases) == [kernel.name]
    got = phases[kernel.name]
    visits = _visits(kernel)
    assert {p: v for p, (_, v) in got.items()} == {p: B * n for p, n in visits.items()}, got
    assert all(c > 0 for c, _ in got.values()), got
    engine.PHASE_CLOCKS.clear()


def test_phase_names_are_the_sources():
    source = engine.SOURCE_W.read_text()
    enum = source[source.index("enum Phase"):].split("{", 1)[1].split("}", 1)[0]
    names = [n.strip() for n in enum.replace("\n", " ").split(",")]
    assert names[-1] == "NPHASE" and len(names) - 1 == len(engine.PHASES)
    tags = {"PH_NARROW": "narrowphase"}
    assert [tags.get(n, n.removeprefix("PH_").lower()) for n in names[:-1]] \
        == list(engine.PHASES)
