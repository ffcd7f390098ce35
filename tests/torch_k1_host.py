"""The kernel sources built by the host C++ compiler (``-DK1_HOST_CHECK``,
``-DK1W_HOST_CHECK``, ``-DK2_HOST_CHECK``): each K1 instance's per-env code
as a plain loop over envs, and K2's two marches as loops over rays, for the
CPU tests.

:func:`build_host` compiles instances of ``csrc/engine_k1.cu`` and of
``csrc/engine_k1w.cu`` (the warp-per-env ones at lane width 1) with the same
preprocessor flags nvcc gets (``ops/cuda/engine.py::compile_flags``: the
named instances by number, any other key as the generic instance), one
compiler per instance, all started together, into one cache directory
(``build/host_check/``, which git ignores): each library is named by its
symbol and a hash of the sources, the compiler and the flags, and written by
an atomic rename, so that every test file and every test worker reuses what
another built; :func:`build_raycast` builds K2's source the same way, with
its ``-DK2_*`` flags. :class:`HostLibrary` builds an instance at the first lookup
of one of its symbols. :func:`run_on_host` runs one kernel wrapper's
instance on numpy inputs (a warp-per-env instance's clocked entry too,
given a buffer for its phase counts).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest

from mocca_envs_tpu_torch.ops.cuda import engine

CACHE = Path(__file__).resolve().parents[1] / "build" / "host_check"
CXX_FLAGS = ("-O2", "-std=c++17", "-x", "c++", "-DK1_HOST_CHECK", "-DK1W_HOST_CHECK",
             "-shared", "-fPIC")


def _compiler() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source's host check")
    return cxx


def _library_path(cxx: str, symbol: str, source: Path, flags) -> Path:
    """Where a host library lies in the cache: its symbol and a hash of its
    source, the shared header, the compiler and the flags."""
    digest = hashlib.sha256()
    for part in (source, engine.HEADER):
        digest.update(part.read_bytes())
    digest.update(" ".join([cxx, *CXX_FLAGS, *flags]).encode())
    return CACHE / f"lib{symbol}_{digest.hexdigest()[:16]}.so"


def _cached_path(cxx: str, inst) -> Path:
    """Where ``inst``'s host library lies in the cache."""
    return _library_path(cxx, inst.symbol, inst.source, engine.compile_flags(inst))


def build_libraries(jobs) -> dict:
    """``{symbol: CDLL}`` of ``jobs`` (``{symbol: (source, preprocessor
    flags)}``), each built unless the cache holds it, the compilers side by
    side; skips the test where no host compiler exists."""
    cxx = _compiler()
    CACHE.mkdir(parents=True, exist_ok=True)
    paths = {symbol: _library_path(cxx, symbol, source, flags)
             for symbol, (source, flags) in jobs.items()}
    running = []
    for symbol, (source, flags) in jobs.items():
        if paths[symbol].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=CACHE)
        os.close(fd)
        cmd = [cxx, *CXX_FLAGS, *flags, "-o", tmp, str(source)]
        running.append((symbol, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True)))
    for symbol, tmp, proc in running:
        log = proc.communicate(timeout=300)[0]
        if proc.returncode != 0:
            os.unlink(tmp)
        assert proc.returncode == 0, f"{symbol}: host build failed:\n{log}"
        os.replace(tmp, paths[symbol])
    return {symbol: ctypes.CDLL(str(path)) for symbol, path in paths.items()}


def build_instances(instances) -> dict:
    """``{symbol: CDLL}`` of ``instances`` (``engine.Instance``)."""
    return build_libraries({inst.symbol: (inst.source, engine.compile_flags(inst))
                            for inst in instances})


def build_raycast(flags=()) -> ctypes.CDLL:
    """The raycast kernel's source (``csrc/raycast_k2.cu``) built for the
    host (``-DK2_HOST_CHECK``) with ``flags`` (``-DK2_G=<n>``,
    ``-DK2_PLACE=<0|1>``): its thread march and its cooperative march as
    loops."""
    flags = ["-DK2_HOST_CHECK", *flags]
    symbol = "_".join([engine.RAYCAST_SYMBOL,
                       *(f.removeprefix("-D").lower().replace("=", "") for f in flags)])
    return build_libraries({symbol: (engine.RAYCAST_SOURCE, flags)})[symbol]


def build_host(kernels) -> dict:
    """``{symbol: CDLL}`` of the instances of ``kernels`` (wrappers)."""
    return build_instances(k.instance for k in kernels)


class HostLibrary:
    """Every named instance, and the instance that runs each named key (its
    named or generic warp-per-env one), behind one handle: looking up
    ``<symbol>_host`` or ``<symbol>_layout`` builds (or takes from the cache)
    that instance's library alone."""

    def __init__(self):
        self._insts = {inst.symbol: inst for inst in (
            *engine.WARP_INSTANCES.values(), *engine.INSTANTIATIONS.values(),
            *map(engine.instance_for, engine.INSTANTIATIONS))}
        self._libs = {}

    def __getattr__(self, name):
        symbol = name.rpartition("_")[0]
        if symbol not in self._insts:
            raise AttributeError(name)
        if symbol not in self._libs:
            self._libs.update(build_instances([self._insts[symbol]]))
        return getattr(self._libs[symbol], name)


def run_on_host(lib, kernel, inputs, clocks=None):
    """``kernel``'s instance in ``lib`` on numpy ``inputs`` (q, qd, tau,
    ground_z, friction, *scene inputs): ``[q', qd', depth, impulse]``. With
    ``clocks``, an int64 ``(B, len(engine.PHASES), 2)`` array, the clocked
    entry (``<symbol>_host_phases``) runs and adds each env's phase counts
    into it."""
    B = inputs[0].shape[0]
    table_size, ws_per_env = engine.layout(lib, kernel.name)
    assert table_size == kernel.table_host.size
    m = kernel.model
    outs = [np.zeros((B, m.nq), np.float32), np.zeros((B, m.nv), np.float32),
            np.zeros((B, m.ns), np.float32), np.zeros((B, m.ns), np.float32)]
    ws = np.zeros(ws_per_env * B, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    fn = getattr(lib, kernel.name + ("_host" if clocks is None else "_host_phases"))
    fn.restype = ctypes.c_int
    named = dict(zip(kernel.inputs, inputs[5:]))
    scene = [ptr(named[k]) if k in named else None
             for k in ("stones", "bars", "grabs", "hf", "tris")]
    if clocks is not None:
        assert clocks.shape == (B, len(engine.PHASES), 2) and clocks.dtype == np.int64
        assert clocks.flags.c_contiguous
    err = fn(*map(ptr, inputs[:5]), *scene, *map(ptr, outs), ptr(kernel.table_host),
             ctypes.c_int(table_size), ptr(ws), ctypes.c_int(B),
             *(() if clocks is None else (ptr(clocks),)))
    assert err == 0
    return outs
