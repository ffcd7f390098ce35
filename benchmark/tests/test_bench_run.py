"""A run end to end on the CPU: no card means no result; without the program
it fails; a sound run at a small batch comes out correct, and a run with the
timed path broken underneath comes out not correct, once for each fault a
cell of this benchmark can have (a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced, and
the two faults in under a tenth of the rows that only the tail and the
parted share see: an answer altered in one slot of sixteen, an episode ended
there that the task goes on with). There is one card a cell, so no exchange
between cards to leave out."""

import copy
import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import cells, run
from benchmark.cells import ROOT

B = 16


def _cell(name="walker3d-custom.b131072"):
    """The cell, with as many sampled steps and rows to compare as a small
    batch gives in a short window on the CPU."""
    cell = cells.find_cell(name)
    config = copy.deepcopy(cell.config)
    config["checks"]["min_rows"] = 2 * B
    traffic = dict(cell.traffic, sample_steps=4, warmup_steps=2, timing_steps=2, trace_steps=2)
    return dataclasses.replace(cell, config=config, traffic=traffic)


def _run(cell, seconds=2.0):
    return run.run_cell(cell, 2**31 + 11, seconds, False, device="cpu", num_envs=B)[0]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "walker3d-custom.b131072", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from benchmark import cells, run\n"
            "run.run_cell(cells.find_cell('walker3d-custom.b131072'), 1, 0.5, False, "
            "device='cpu', num_envs=4)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "mocca_envs_tpu_torch" in out.stderr


def test_sound_run_is_correct():
    result = _run(_cell())
    assert result["correct"], result["checks"]
    assert result["attempted"] >= B * 4 and result["failed"] == 0
    assert set(result["metrics"]) == {"env_steps_per_s", "step_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"


def _broken(monkeypatch, fault):
    """Break ``BatchedEnv.step`` underneath the harness."""
    from mocca_envs_tpu_torch.envs.env import BatchedEnv, make_fn_env

    real = BatchedEnv.step

    def step(self, state, actions):
        if fault == "ended":
            # slot 0 ends its episode every step, reset as a done slot is
            env = self.env

            def raw_step(state, action, gen):
                tr = env.step_no_reset(state, action, gen)
                tr.done = tr.done | (torch.arange(tr.done.shape[0]) == 0)
                return tr

            faulty = make_fn_env(name=env.name, obs_dim=env.obs_dim, act_dim=env.act_dim,
                                 reset=env.reset, raw_step=raw_step, obs_fn=env.obs_fn,
                                 control_dt=env.control_dt, device=env.device,
                                 mirror=env.mirror, model=env.model,
                                 reset_obs_fn=env.reset_obs_fn)
            return faulty.step(state, actions, self.generator)
        tr = real(self, state, actions)
        if fault == "unchanged":
            tr.state.q, tr.state.qd = state.q, state.qd
        elif fault == "half":
            keep = torch.arange(state.q.shape[0]) < state.q.shape[0] // 2
            tr.state.q = torch.where(keep[:, None], state.q, tr.state.q)
            tr.state.qd = torch.where(keep[:, None], state.qd, tr.state.qd)
        elif fault == "altered":
            tr.reward = tr.reward + 0.01
        elif fault == "altered_in_one":
            tr.reward = tr.reward + 0.1 * (torch.arange(tr.reward.shape[0]) == 0)
        return tr

    monkeypatch.setattr(BatchedEnv, "step", step)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "altered_in_one", "ended"])
def test_broken_step_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    result = _run(_cell())
    assert not result["correct"], result["checks"]
    checks = result["checks"]
    if fault in ("altered_in_one", "ended"):
        # a fault in under a tenth of the rows passes every p90 and the
        # bookkeeping; the reward's tail or the share of rows where the
        # sides part fails it
        assert all(v <= lim for name, (v, lim) in checks.items()
                   if name.endswith("_p90") or name == "bookkeeping_bad"), checks
        name = "reward_p99" if fault == "altered_in_one" else "parted"
        assert checks[name][0] > checks[name][1], checks


def test_traced_run_reads_host_ops():
    result = run.run_cell(_cell(), 5, 3.0, True, device="cpu", num_envs=B)[0]
    assert result["correct"], result["checks"]
    # on the CPU the trace holds no device event: only the host count reads
    assert set(result["metrics"]) <= {"host_ops_per_step"}
    assert "busy_s" not in result["device"]
