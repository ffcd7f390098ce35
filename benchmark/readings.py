"""The readings a cell's limits are set from, in one process on the card:

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 --seconds 3 \
        [--control 3]

For each seed, one run of the cell (:func:`run.run_cell`) with a short
window at its own size, and the comparison's numbers for what the program
produced (the lower readings). For the first ``--control`` seeds, each
control of :data:`judge.CONTROLS` on the same sampled rows: the reference
at the precision next below the float32 with TF32 off that the
configurations state, put in the program's place and judged against the
reference in float32 (the upper readings). One JSON line per reading on
standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import cells, judge, run


def control_numbers(ref, pre: dict, action, control: str, block: int = 4096) -> dict:
    """The comparison's numbers of the reference under ``control`` (a key
    of :data:`judge.CONTROLS`) against itself in float32, on the same rows."""
    import torch

    outs = []
    with judge.CONTROLS[control]():
        for lo in range(0, action.shape[0], block):
            sl = slice(lo, lo + block)
            p = {k: v[sl] for k, v in pre.items()}
            outs.append(ref.step(p, action[sl], {"task.target": p.get("task.target")}))
    post = {k: torch.cat([o[k] for o in outs]) for k in ("q", "qd", "obs", "reward", "done",
                                                         *[k for k in outs[0]
                                                           if k.startswith("task.")])}
    with judge.fp32_products():
        g, _ = judge.gaps(ref, pre, action, post, raw=True, block=block)
    return judge.numbers(g)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the controls")
    args = ap.parse_args(argv)
    run.keep_caches_in_checkout()
    import torch

    if not torch.cuda.is_available():
        print("the readings need a CUDA card", file=sys.stderr)
        return 2
    cell = cells.find_cell(args.workload)
    for j, seed in enumerate(int(s) for s in args.seeds.split(",")):
        result, nums, (ref, pre, action) = run.run_cell(cell, seed, args.seconds, False,
                                                        t_start=time.perf_counter())
        line = {"workload": cell.name, "seed": seed, "side": "program",
                "correct": result["correct"], "rows": action.shape[0], **nums}
        print(json.dumps(line), flush=True)
        for control in judge.CONTROLS if j < args.control else ():
            t1 = time.perf_counter()
            line = {"workload": cell.name, "seed": seed, "side": f"control_{control}",
                    "rows": action.shape[0], **control_numbers(ref, pre, action, control),
                    "reference_s": time.perf_counter() - t1}
            print(json.dumps(line), flush=True)
        del ref, pre, action
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
