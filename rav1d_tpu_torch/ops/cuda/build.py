"""Build the port's CUDA sources into shared libraries at first use.

Each library is compiled by nvcc for sm_90a from the checkout's sources
(csrc/) into rav1d_tpu_torch/build/, named by a hash of its sources so an
edited source rebuilds, and loaded with ctypes. A failed build raises with
the compiler's output; a build that succeeds keeps it in `LOGS` (ptxas's
registers, stack frame and spills of every kernel and function). Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")

_LIBS = {}
LOGS = {}  # library name -> compiler output of its build in this process
_LOCK = threading.Lock()
_NAME_LOCKS = {}  # one lock per library: different libraries build at once


def _sources_hash(paths):
    h = hashlib.sha1()
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def nvcc_path():
    cand = shutil.which("nvcc")
    if cand:
        return cand
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build(name, main, deps=()):
    """Compile csrc/<main> (+ headers `deps`) into build/lib<name>-<hash>.so
    and return the loaded ctypes library."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [os.path.join(CSRC, main)] + [os.path.join(CSRC, d) for d in deps]
        so = os.path.join(BUILD, f"lib{name}-{_sources_hash(srcs)}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [
                nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                "-Xcompiler", "-fPIC", "-o", tmp, srcs[0],
            ]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    "nvcc failed for %s:\n%s%s" % (main, r.stdout, r.stderr)
                )
            os.replace(tmp, so)
            LOGS[name] = r.stdout + r.stderr
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
