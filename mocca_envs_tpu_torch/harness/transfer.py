"""Policy transfer across env families (ALLSTEPS pretrain → stepper).

Counterpart of ``mocca_envs_tpu/harness/transfer.py``. The walker's obs
``[body, q, q̇, feet]`` is an exact prefix of the stepper's ``[body, q, q̇,
feet, targets]`` and the action layouts are the same, so a pretrained
network embeds structurally: where a tensor grew, the source fills its
leading block (the first layer's weight gains columns for the new inputs,
which keep their fresh values), and every other tensor copies. The running
obs normalizer embeds the same way.
"""

from __future__ import annotations

import dataclasses

import torch


def embed_pytree(src, dst):
    """Copy ``src`` into ``dst`` leaf by leaf (tensors, dicts such as a
    state dict, dataclasses such as a RunningNorm); where a tensor grew
    (same rank, every src dim ≤ dst dim), src fills the leading block and
    dst keeps its values for the rest. Returns new tensors: neither
    argument is modified or aliased."""
    if isinstance(dst, torch.Tensor):
        src = torch.as_tensor(src)
        if src.shape == dst.shape:
            return src.to(dtype=dst.dtype, device=dst.device).clone()
        if src.dim() == dst.dim() and all(a <= b for a, b in zip(src.shape, dst.shape)):
            out = dst.clone()
            out[tuple(slice(0, n) for n in src.shape)] = src.to(dtype=dst.dtype,
                                                               device=dst.device)
            return out
        raise ValueError(f"cannot embed leaf {tuple(src.shape)} into {tuple(dst.shape)}")
    if isinstance(dst, dict):
        if set(src) != set(dst):
            raise ValueError(f"cannot embed keys {sorted(src)} into {sorted(dst)}")
        return type(dst)((k, embed_pytree(src[k], v)) for k, v in dst.items())
    if dataclasses.is_dataclass(dst):
        return dataclasses.replace(dst, **{f.name: embed_pytree(getattr(src, f.name),
                                                                getattr(dst, f.name))
                                           for f in dataclasses.fields(dst)})
    raise TypeError(f"cannot embed a {type(dst).__name__}")


def transfer_train_state(src_state, dst_state, reset_log_std: float | None = None):
    """Embed a pretrained train state into a freshly initialised one: the
    network (loaded into ``dst_state``'s module in place) and the obs
    normalizer; the optimizer, env states and generators stay fresh, so the
    curriculum starts clean. ``reset_log_std`` re-opens exploration on the
    new task by setting the policy's log-std to it."""
    params = embed_pytree(src_state.params.state_dict(), dst_state.params.state_dict())
    if reset_log_std is not None:
        params["log_std"] = torch.full_like(params["log_std"], reset_log_std)
    dst_state.params.load_state_dict(params)
    return dataclasses.replace(dst_state,
                               obs_norm=embed_pytree(src_state.obs_norm, dst_state.obs_norm))
