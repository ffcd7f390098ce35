"""Metrics aggregation and host logging.

Counterpart of ``mocca_envs_tpu/harness/metrics.py``: every env step emits a
metrics dict (``envs/env.Transition.metrics``); :func:`aggregate` reduces
them on the device, :func:`merge_means` averages such dicts on the host, and
:class:`MetricsLogger` writes one line per logged step to python logging and
optionally to a JSONL file (the JAX package's lines: ``{"step": n, ...,
"wall_s": s}``) and to TensorBoard.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Iterable

import torch

logger = logging.getLogger("mocca_envs_tpu_torch")


def aggregate(metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Mean-reduce every metric over all its axes (time, batch)."""
    return {k: torch.as_tensor(v, dtype=torch.float32).mean() for k, v in metrics.items()}


def merge_means(dicts: Iterable[dict]) -> dict:
    out: dict = {}
    n = 0
    for d in dicts:
        n += 1
        for k, v in d.items():
            out[k] = out.get(k, 0.0) + float(v)
    return {k: v / max(n, 1) for k, v in out.items()}


class MetricsLogger:
    """Host logger: python logging, and optionally JSONL and TensorBoard. A
    ``tensorboard_dir`` without TensorBoard installed warns and is skipped."""

    def __init__(self, jsonl_path: str | None = None, tensorboard_dir: str | None = None):
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logger.warning("tensorboard writer unavailable; skipping")
            else:
                self._tb = SummaryWriter(tensorboard_dir)
        self._t0 = time.time()

    def log(self, step: int, metrics: dict) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        scalars["wall_s"] = round(time.time() - self._t0, 1)
        logger.info("step %d: %s", step, json.dumps(scalars, sort_keys=True))
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
