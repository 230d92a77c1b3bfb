"""Build and load the hand-written CUDA kernels of ``kernels/csrc/``.

The sources are compiled at first use, on the machine with the card, by
``nvcc`` for ``sm_90a``: one ``nvcc -c`` per ``.cu`` file, all started
together, then one link into a single shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in
``kernels/_build/`` under a name that hashes the sources and flags, so an
edit rebuilds and an unchanged tree reuses it.  Nothing here runs at import
time; a missing ``nvcc`` or a failed build raises.

No ``--use_fast_math``: it swaps ``tanhf``/``sinf``/``cosf`` for
approximations that break parity with the plain versions at order >= 3.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_D = ctypes.c_double
_SIGNATURES = {
    # x, out, n_elem, n1, act, dtype, stream
    "act_jet_launch": (_P, _P, _I64, _I, _I, _I, _P),
    # x, w, bias, out, bsz, din, dout, n1, act, dtype, stream
    "jet_dense_launch": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _P),
    # x, gamma, out, bsz, width, n1, dtype, eps, stream
    "jet_rms_norm_launch": (_P, _P, _P, _I64, _I, _I, _I, _D, _P),
    # q, k, v, wo, out, bsz, heads, t, dh, dm, n1, dtype, scale, mask,
    # window, group, rows, key_tile, dpl, stream
    "jet_flash_attention_launch": (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                                   _I, _I, _D, _I, _I, _I, _I, _I, _I, _P),
    # q, k, out, bsz, t, d, n1, dtype, scale, groups, split, tiles, ring,
    # stream
    "jet_attention_scores_launch": (_P, _P, _P, _I64, _I, _I, _I, _I, _D, _I,
                                    _I, _I, _I, _P),
    # the run-time-order kernels (csrc/jet_runtime.cu): any N1, bfloat16
    # x, out, n_elem, n1, act, dtype, tab, reals, n_ints, n_reals, units,
    # warps, staged, stream
    "act_jet_rt_launch": (_P, _P, _I64, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                          _P),
    # x, w, bias, out, bsz, din, dout, n1, act, dtype, tab, reals, n_ints,
    # n_reals, rows, kc, warps, staged, stream
    "jet_dense_rt_launch": (_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P),
    # x, gamma, out, bsz, width, n1, dtype, eps, vec, group, warps, staged,
    # stream
    "jet_rms_norm_rt_launch": (_P, _P, _P, _I64, _I, _I, _I, _D, _I, _I, _I, _I,
                               _P),
    # q, k, v, wo, out, bsz, heads, t, dh, dm, n1, dtype, scale, mask,
    # window, group, rows, key_tile, stream
    "jet_flash_attention_rt_launch": (_P, _P, _P, _P, _P, _I64, _I, _I, _I,
                                      _I, _I, _I, _D, _I, _I, _I, _I, _I, _P),
    # q, k, out, bsz, t, d, n1, dtype, scale, groups, split, tiles, ring,
    # stream
    "jet_attention_scores_rt_launch": (_P, _P, _P, _I64, _I, _I, _I, _I, _D,
                                       _I, _I, _I, _I, _P),
}


class LaunchCounter:
    """Launches of one kernel, counted by its wrapper right after a launch
    that the runtime accepted (thread-safe: the server launches from its
    worker thread)."""

    def __init__(self, name: str):
        self.name = name
        self._count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self) -> None:
        with self._lock:
            self._count = 0


class _Library:
    """The loaded shared library plus how long its build took."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds = None
        self.build_log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                t0 = time.perf_counter()
                path = _build()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.jetk_error_string.argtypes = [ctypes.c_int]
                lib.jetk_error_string.restype = ctypes.c_char_p
                log = path.with_suffix(".log")
                self.build_log = log.read_text() if log.exists() else ""
                self.build_seconds = time.perf_counter() - t0
                self._lib = lib
            return self._lib


LIBRARY = _Library()


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    return LIBRARY.get()


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = library().jetk_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def launch(name: str, device, *args) -> None:
    """Call the library's launcher ``name`` with ``args`` on ``device``'s
    current stream (the device made current around the call); raise on a
    CUDA error."""
    with torch.cuda.device(device):
        rc = getattr(library(), name)(*args,
                                      torch.cuda.current_stream().cuda_stream)
    check(rc, name.removesuffix("_launch"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    target = BUILD_DIR / f"libjetkernels_{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so = Path(tmp) / target.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(so)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        target.with_suffix(".log").write_text("\n".join(logs))
        os.replace(so, target)
    return target
