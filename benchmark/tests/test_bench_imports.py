"""No JAX in a benchmark process, and nothing of the program in the
reference; names compared by their top-level part, whole."""

import subprocess
import sys

from benchmark import imports
from benchmark.cells import ROOT


def test_top_level_names_compared_whole():
    names = ["mocca_envs_tpu_torch.ops.step", "mocca_envs_tpu.ops", "jaxlib.xla_client",
             "jaxtyping", "flax", "jax", "benchmark.run", "mocca_envs_tpu_tools"]
    assert imports.forbidden_loaded(names) == ["flax", "jax", "jaxlib.xla_client",
                                               "mocca_envs_tpu.ops"]


def test_reference_imports_nothing_of_the_program():
    assert imports.reference_violations() == []


def test_a_planted_import_is_found(tmp_path):
    (tmp_path / "ok.py").write_text("import torch\nfrom benchmark.reference import quat\n")
    (tmp_path / "bad.py").write_text(
        "def f():\n    from mocca_envs_tpu_torch.ops import step\n    import jax.numpy\n")
    assert imports.reference_violations(tmp_path) == [("bad.py", "jax.numpy"),
                                                      ("bad.py", "mocca_envs_tpu_torch.ops")]


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_no_program_and_no_jax():
    mods = _loaded("import benchmark.roofline, benchmark.judge\n"
                   "from benchmark import cells\n"
                   "for n in ('walker3d-custom.b131072', 'cassie.b32768'):\n"
                   "    cells.reference(cells.find_cell(n).config, 'cpu')")
    assert imports.forbidden_loaded(mods) == []
    assert not [m for m in mods if imports.top(m) == imports.PROGRAM]


def test_a_run_loads_no_jax():
    mods = _loaded("from benchmark import cells, run\n"
                   "cell = cells.find_cell('walker3d-custom.b131072')\n"
                   "run.run_cell(cell, 3, 0.5, True, device='cpu', num_envs=8)")
    assert imports.forbidden_loaded(mods) == []
