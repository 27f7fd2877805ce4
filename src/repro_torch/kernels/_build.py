"""Build, load and launch helpers for the hand-written CUDA kernels.

``csrc/*.cu`` is compiled at first use with one ``nvcc`` call per source into
a shared library with a plain C interface under ``build/repro_torch/`` at the
repository root, and loaded with ``ctypes``.  The library name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale library
is never loaded.  The build runs once per process under a lock: the serving
runtime's worker threads may all reach their first kernel together.

``library(checked=True)`` builds the same sources with ``-DREPRO_CHECKED
-lineinfo`` into a second, separately hashed library: there ``REPRO_CHECK``
guards in the kernels trap on an index outside its tensor or buffer.  It is
for checks only (``chip_smoke.py`` runs the sweeps of B1, B2, B4, B7 and B8
through it); every wrapper launches from the unchecked library unless its
caller asks for the checked one.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent code must not need ``nvcc`` or a card until a kernel is
actually launched on a CUDA tensor.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas=-v")
LINK_FLAGS = (*ARCH, "-shared")
CHECKED_FLAGS = ("-DREPRO_CHECKED", "-lineinfo")

# ctypes signatures of the C entry points (pointers and the stream as
# c_void_p: ctypes would otherwise pass them as 32-bit ints and cut them)
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_SIGNATURES = {
    "repro_parity_encode": [_P, _P, _P, _I, _I, _LL, _I, _P],
    "repro_parity_decode": [_P, _P, _P, _P, _I, _LL, _I, _P],
    "repro_multigroup_decode": [_P, _P, _P, _P, _P, _I, _I, _LL, _I, _I,
                                _P],
    "repro_fused_encode_forward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _P],
    "repro_learned_project": [_P, _P, _P, _I, _I, _LL, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _F, _I, _P],
    "repro_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _F, _I, _P],
    "repro_decode_cluster_capacity": [_I, _I, _I, _P],
    "repro_fused_plan": [_I, _I, _I, _I, _I, _I, _I, _P, _P],
    "repro_empty_launch": [_P],
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs = {}                # checked -> loaded library
build_log = ""            # nvcc's output (ptxas register/spill report)


class LaunchCounter:
    """Thread-safe count of kernel launches: each wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that its main
    path went through the kernel."""

    def __init__(self, name):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self):
        with self._lock:
            self._n += 1

    def reset(self):
        with self._lock:
            self._n = 0

    @property
    def value(self):
        return self._n


def nvcc():
    """The path of the CUDA compiler (PATH, then $CUDA_HOME/bin); raises
    where there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are built from csrc/ at first use and need the CUDA "
        "toolkit")


def _compile(sources, out, flags):
    """One nvcc per source into an object, all started together, then one
    link; returns the concatenated compiler output."""
    exe = nvcc()
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources:
        obj = tmp / (src.stem + ".o")
        objs.append(obj)
        cmd = [exe, *flags, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, p in procs:
        text, _ = p.communicate()
        logs.append(text)
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    lib_tmp = tmp / out.name
    cmd = [exe, *LINK_FLAGS, *map(str, objs), "-o", str(lib_tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(
            f"nvcc link failed:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(lib_tmp, out)           # atomic: other processes see all or
    shutil.rmtree(tmp, ignore_errors=True)   # nothing
    return "".join(logs)


def library(checked=False):
    """The loaded kernel library, built on first call (once per process and
    kind, under a lock); ``checked=True`` is the bounds-checked build.
    Raises if the build or the load fails."""
    global build_log
    if checked in _libs:
        return _libs[checked]
    with _lock:
        if checked in _libs:
            return _libs[checked]
        flags = COMPILE_FLAGS + (CHECKED_FLAGS if checked else ())
        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(flags + LINK_FLAGS).encode())
        for src in sources:
            h.update(src.read_bytes())
        kind = "_checked" if checked else ""
        out = BUILD_DIR / f"libparity_kernels{kind}_{h.hexdigest()[:12]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            log = _compile(sources, out, flags)
            if not checked:
                build_log = log
        lib = ctypes.CDLL(str(out))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[checked] = lib
        return lib


def dtype_code(dtype):
    if dtype not in _DTYPE_CODES:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {dtype}")
    return _DTYPE_CODES[dtype]


def require_cuda(name, *tensors):
    """Validate what a kernel takes: CUDA tensors on one device, each
    contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: kernel inputs must be CUDA tensors on one device, "
                f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")


def require_aligned(name, *tensors):
    """Validate 16-byte aligned data pointers (kernels that load 16 bytes
    at a time)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel inputs must start 16-byte "
                             f"aligned")


def stream(device):
    """The raw ``cudaStream_t`` of ``device``'s current stream, as an int.
    PyTorch's private accessor (the one its own compiled kernels use):
    ``torch.cuda.current_stream()`` builds a Stream object on every call,
    several microseconds of each launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def device_guard(device):
    """Make ``device`` the current device around a launch; a no-op context
    when it already is (``torch.cuda.device`` costs microseconds even
    then)."""
    if device.index == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(rc, name):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
