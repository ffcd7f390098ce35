"""The K1 kernel sources built by the host C++ compiler (``-DK1_HOST_CHECK``,
``-DK1W_HOST_CHECK``): each instance's per-env code as a plain loop over
envs, for the CPU tests.

:func:`build_host` compiles instances of ``csrc/engine_k1.cu`` (and the
warp-per-env K1a of ``csrc/engine_k1w.cu`` at lane width 1) with the same
preprocessor flags nvcc gets (``ops/cuda/engine.py::compile_flags``: the
named instances by number, any other key as the generic instance), one
compiler per instance, all started together; :func:`run_on_host` runs one
kernel wrapper's instance on numpy inputs.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from mocca_envs_tpu_torch.ops.cuda import engine


def build_host(kernels, out_dir) -> dict:
    """``{symbol: CDLL}`` of the instances of ``kernels`` (wrappers), built
    into ``out_dir``; skips the test where no host compiler exists."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's host check")
    insts = {k.instance.symbol: k.instance for k in kernels}
    running = []
    for symbol, inst in insts.items():
        path = out_dir / f"lib{symbol}_host.so"
        cmd = [cxx, "-O2", "-std=c++17", "-x", "c++", "-DK1_HOST_CHECK", "-DK1W_HOST_CHECK",
               *engine.compile_flags(inst), "-shared", "-fPIC", "-o", str(path),
               str(inst.source)]
        running.append((symbol, path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for symbol, path, proc in running:
        log = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, f"{symbol}: host build failed:\n{log}"
        libs[symbol] = ctypes.CDLL(str(path))
    return libs


def run_on_host(lib, kernel, inputs):
    """``kernel``'s instance in ``lib`` on numpy ``inputs`` (q, qd, tau,
    ground_z, friction, *scene inputs): ``[q', qd', depth, impulse]``."""
    B = inputs[0].shape[0]
    table_size, ws_per_env = engine.layout(lib, kernel.name)
    assert table_size == kernel.table_host.size
    m = kernel.model
    outs = [np.zeros((B, m.nq), np.float32), np.zeros((B, m.nv), np.float32),
            np.zeros((B, m.ns), np.float32), np.zeros((B, m.ns), np.float32)]
    ws = np.zeros(ws_per_env * B, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = getattr(lib, kernel.name + "_host")
    fn.restype = ctypes.c_int
    named = dict(zip(kernel.inputs, inputs[5:]))
    scene = [ptr(named[k]) if k in named else None
             for k in ("stones", "bars", "grabs", "hf", "tris")]
    err = fn(*map(ptr, inputs[:5]), *scene, *map(ptr, outs), ptr(kernel.table_host),
             ctypes.c_int(table_size), ptr(ws), ctypes.c_int(B))
    assert err == 0
    return outs
