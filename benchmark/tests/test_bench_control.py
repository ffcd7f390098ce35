"""The controls come out not correct: the reference at the precision next
below the configurations' float32 with TF32 off, put in the program's place
and judged by each cell's limits. With every product's operands rounded to
TF32 it fails every gap the cells hold, at 64 slots on the CPU and at 1,024
on a card; with TF32 allowed on a card (cuBLAS's tensor-core kernels, which
take some of Cassie's products and none of the walker's) it fails Cassie.
``python3 -m benchmark.readings`` reads both at the cells' own sizes."""

import time

import pytest
import torch

from benchmark import cells, judge, readings, window

CELLS = ["walker3d-custom.b131072", "cassie.b32768"]


def _control(name, device, num_envs, control="tf32_products"):
    cell = cells.find_cell(name)
    runner = window.Runner(cell, 17, device, num_envs=num_envs)
    win = runner.run(2.0, time.perf_counter(), trace=False)
    capture = runner.capture
    runner.free()
    ref = cells.reference(cell.config, device)
    pre, action, _ = capture.sample(win.captures)
    nums = readings.control_numbers(ref, pre, action, control)
    ok, checks = judge.verdict(nums, 0, action.shape[0], cell.config["checks"]["limits"], 1)
    assert not ok, checks
    if control == "tf32_products":
        # every compared gap fails it (rounding parts no more rows than a
        # threshold's few, so ``parted`` is not among them)
        assert all(v > lim for name, (v, lim) in checks.items()
                   if name in cell.config["checks"]["limits"] and name != "parted"), checks
    # the same rows judged in float32 against themselves, in one block of
    # the same shape (a card may round another batch shape otherwise),
    # read no gap
    with judge.fp32_products():
        outs = ref.step(pre, action, {"task.target": pre.get("task.target")})
        g, _ = judge.gaps(ref, pre, action, outs, raw=True, block=action.shape[0])
    assert all(v == 0 for v in judge.numbers(g).values()), judge.numbers(g)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, 3.14159265, -2.5e-3])
    want = [1.0, 1.0, 1.0 + 2**-9, 3.140625, -0.0025005340576171875]
    assert judge.round_tf32(x).tolist() == want
    a, b = torch.randn(4, 5), torch.randn(5, 3)
    with judge.tf32_products():
        c = a @ b
        d = torch.einsum("ij,jk->ik", a, b)
    assert torch.equal(c, d) and not torch.equal(c, a @ b)
    assert torch.equal(c, judge.round_tf32(a) @ judge.round_tf32(b))


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(name):
    _control(name, "cpu", 64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct_on_the_card(card, name):
    _control(name, "cuda", 1024)


@pytest.mark.cuda
def test_tf32_on_the_card_is_not_correct_for_cassie(card):
    _control("cassie.b32768", "cuda", 1024, control="tf32")
