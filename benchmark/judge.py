"""The comparison that decides ``correct``.

What the timed path produced at a sample of slots and steps (the state
before each sampled step, its action, and what the step gave back) is held
against the plain reference, which works the step out again from the same
state and action. Per sampled slot-step:

- where the program and the reference agree that the episode goes on, the
  gaps of q, q̇, the observation and the reward (the largest absolute
  difference over the row), and the task state kept (:meth:`carry_ok`);
- where both end it, the terminal reward's gap, and the fresh episode that
  auto-reset put in: drawn as the configuration's reset draws
  (:meth:`reset_ok`, exact) and observed as the reset observes
  (the observation's gap);
- where they part (one ends the episode, the other does not; or the task
  state does not carry) every gap of the row reads ``PARTED`` (1e30);
- the bookkeeping of every row, exact: steps counted on or restarted,
  resets counted, a non-finite state counted as a blow-up with reward −1.

The compared numbers are percentiles of those gaps over the sample, and
the share of rows where the two sides part (``parted``), which no
percentile below the parted share sees; a configuration names which, each
with its limit (``checks``). A row's gap that does not apply (q of a fresh
episode) is left out of its percentile.
"""

from __future__ import annotations

import contextlib

import torch

# the gap percentiles a run reports; a configuration's ``checks`` compare some
QUANTITIES = ("q", "qd", "obs", "reward")
PERCENTILES = (50, 90, 99)
# the gap of a row where the two sides part, and of a percentile with no
# row to read: finite, so that the result line stays plain JSON
PARTED = 1e30


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest, ties
    to even: what the tensor cores take of a float32 operand."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


class _TF32Products(torch.overrides.TorchFunctionMode):
    """Every matrix product's float32 operands rounded to TF32."""

    PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.bmm,
                torch.mm, torch.einsum}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.PRODUCTS:
            def cut(a):
                if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
                    return round_tf32(a)
                if isinstance(a, (list, tuple)):
                    return type(a)(cut(b) for b in a)
                return a
            args = tuple(cut(a) for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32_products():
    """A control's precision: every product's float32 operands rounded to
    TF32 as the tensor cores take them, float32 elsewhere, on any device.
    It reaches the products that cuBLAS keeps on its float32 kernels under
    :func:`tf32_on` (all of the walker's)."""
    with fp32_products(), _TF32Products():
        yield


@contextlib.contextmanager
def _allow_tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp32_products():
    """Matrix products in full float32 (TF32 off), as the configurations
    state; the flags are restored after."""
    return _allow_tf32(False)


def tf32_on():
    """A control's precision as the card gives it: TF32 allowed, so cuBLAS
    may take its tensor-core kernels; the flags are restored after."""
    return _allow_tf32(True)


# the controls: the reference put in the program's place at the precision
# next below the float32 with TF32 off that the configurations state
CONTROLS = {"tf32": tf32_on, "tf32_products": tf32_products}


def _rowmax(x):
    return x.abs().reshape(x.shape[0], -1).amax(dim=1)


def gaps(ref_family, pre: dict, action, post: dict, raw: bool = False, block: int = 4096):
    """Per-row gaps ``{quantity: (N,)}`` (NaN where a quantity does not
    apply, ``PARTED`` where the two sides part) and the number of rows whose exact
    bookkeeping is wrong. ``pre`` / ``post`` map field names (``q``, ``qd``,
    ``steps``, ``reset_count``, ``blowup_count``, ``task.<field>``; and in
    ``post`` ``obs``, ``reward``, ``done``) to (N, ...) tensors on the
    reference's device. ``raw``: ``post`` is a raw step with no auto-reset
    (the control), so done rows are compared like the others and the
    bookkeeping is not judged."""
    n = action.shape[0]
    if n == 0:
        return {k: action.new_empty(0) for k in QUANTITIES}, 0
    out = {k: [] for k in QUANTITIES}
    bad = 0
    for lo in range(0, n, block):
        sl = slice(lo, min(lo + block, n))
        p = {k: v[sl] for k, v in pre.items()}
        o = {k: v[sl] for k, v in post.items()}
        a = action[sl]
        ref = ref_family.step(p, a, o)
        finite = (torch.isfinite(ref["q"]).all(dim=1) & torch.isfinite(ref["qd"]).all(dim=1)
                  & torch.isfinite(ref["reward"]))
        ref_done = ref["done"] | ~finite
        ref_reward = torch.where(finite, ref["reward"], torch.full_like(ref["reward"], -1.0))
        done = o["done"]
        nan = torch.full_like(ref_reward, float("nan"))
        if raw:
            goes_on = torch.ones_like(done)
            part = done != ref_done
        else:
            goes_on = ~done
            part = (done != ref_done) | (goes_on & ~ref_family.carry_ok(o, ref))
        g = {
            "q": torch.where(goes_on, _rowmax(o["q"] - ref["q"]), nan),
            "qd": torch.where(goes_on, _rowmax(o["qd"] - ref["qd"]), nan),
            "obs": _rowmax(o["obs"] - torch.where(goes_on[:, None], ref["obs"],
                                                  ref_family.reset_obs(o))),
            "reward": (o["reward"] - ref_reward).abs(),
        }
        for k in QUANTITIES:
            out[k].append(torch.where(part, torch.full_like(g[k], PARTED), g[k]))
        if not raw:
            bad += int(_bookkeeping_bad(ref_family, p, o).sum())
    return {k: torch.cat(v) for k, v in out.items()}, bad


def _bookkeeping_bad(ref_family, pre: dict, post: dict):
    """Rows whose counters or fresh episode break the step's contract."""
    done = post["done"]
    blown = post["blowup_count"] - pre["blowup_count"]
    restarted = ((post["steps"] == 0) & (post["reset_count"] == pre["reset_count"] + 1)
                 & ((blown == 0) | ((blown == 1) & (post["reward"] == -1.0)))
                 & ref_family.reset_ok(post))
    counted = ((post["steps"] == pre["steps"] + 1) & (post["reset_count"] == pre["reset_count"])
               & (blown == 0))
    return torch.where(done, ~restarted, ~counted)


def numbers(g: dict) -> dict:
    """``<quantity>_p<percentile>`` of each gap over the rows where it
    applies (``PARTED`` where none does), and the share of rows where the
    two sides part."""
    out = {}
    for k, v in g.items():
        v = v.double()
        for p in PERCENTILES:
            x = float(torch.nanquantile(v, p / 100.0)) if v.numel() else PARTED
            out[f"{k}_p{p}"] = x if x == x else PARTED
    out["parted"] = float((g["reward"] == PARTED).double().mean()) if g["reward"].numel() else 1.0
    return out


def verdict(nums: dict, bad: int, rows: int, limits: dict, min_rows: int) -> tuple:
    """(correct, the compared numbers ``{name: [value, limit]}``): every
    number named in ``limits`` within its limit, no bookkeeping row wrong,
    and at least ``min_rows`` rows compared."""
    compared = {name: [nums[name], float(lim)] for name, lim in limits.items()}
    compared["bookkeeping_bad"] = [float(bad), 0.0]
    compared["rows"] = [float(rows), float(min_rows)]
    ok = (all(v <= lim for name, (v, lim) in compared.items() if name != "rows")
          and rows >= min_rows)
    return ok, compared
