"""Hand-written CUDA kernels for the blocked-ELL sparse HVP, and their
launch wrappers.

Two kernels, in ``csrc/``, each compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C entry point and called through ctypes on
PyTorch's current stream:

* ``ell_mv``  (``csrc/ell_mv.cu``) — ``y = A (c .* v)`` on a blocked-ELL
  operand; replaces ``repro/kernels/sparse_hvp.py::ell_mv``.
* ``ell_hvp`` (``csrc/ell_hvp.cu``) — the fused ``y = A (c .* (A^T u))``
  from the transposed layout alone; replaces
  ``repro/kernels/sparse_hvp.py::ell_hvp``.

The libraries are built from the sources in this package at first use
(or by :func:`build_kernels`, one ``nvcc`` per source, all started
together) into ``build/torch_ext/`` at the repository root, named by a
hash of their sources so an edited kernel is rebuilt. A failed build or
launch raises; nothing here falls back to the plain versions in
:mod:`repro_torch.kernels.ref`.

Each wrapper adds one to its kernel's ``launches`` count when it launches
the kernel and nowhere else, so a run can show that it went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
THREADS = 256          # threads per CTA for both kernels
BUILD_TIMEOUT_S = 600


class _CudaKernel:
    """One kernel's source, its built library's entry point, and the
    count of its launches."""

    def __init__(self, name: str, argtypes: list):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (self.source, CSRC / "ell_common.cuh"):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}-{h.hexdigest()[:16]}.so"

    def entry(self):
        """The C entry point, building and loading the library first."""
        if self._fn is None:
            path = self.library_path()
            if not path.exists():
                build_kernels([self])
            fn = getattr(ctypes.CDLL(str(path)), f"{self.name}_launch")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


_P, _I = ctypes.c_void_p, ctypes.c_int
# (tiles, cols, vector, c, y, n_blocks, W, rows, cols-per-tile, n_out_blocks,
#  threads, stream)
ELL_MV = _CudaKernel("ell_mv", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _P])
ELL_HVP = _CudaKernel("ell_hvp", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _P])
KERNELS = (ELL_MV, ELL_HVP)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (CUDA_HOME, "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def build_kernels(kernels=KERNELS) -> dict[str, str]:
    """Compile the kernels' libraries that are not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: ptxas report}``
    for the kernels compiled by this call; raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for k in kernels:
            out = k.library_path()
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(k.source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((k, proc, tmp, out))
        reports = {}
        for k, proc, tmp, out in jobs:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            (BUILD_DIR / f"{k.name}.log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {k.source}:\n{log}")
            os.replace(tmp, out)
            reports[k.name] = log
        return reports
    finally:
        for _, proc, tmp, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _check(name, t, dtype, ndim, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {device}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"{torch.cuda.get_device_name(device)} is "
                           f"sm_{cap[0]}{cap[1]}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def ell_mv(data, cols, v, c=None, *, out_dtype=torch.float32):
    """y = A @ (c .* v) for a blocked-ELL operand, on the card.

    data : (nb, W, br, bc) f32 tiles;  cols : (nb, W) int32
    v    : (ncb * bc,) f32 input vector (padded length)
    c    : optional (ncb * bc,) f32 per-element scale (fused in-kernel)
    returns (nb * br,) in ``out_dtype`` (f32 accumulation)
    """
    dev = data.device
    _check_card(dev)
    _check("data", data, torch.float32, 4, dev)
    nb, w, br, bc = data.shape
    _check("cols", cols, torch.int32, 2, dev)
    if tuple(cols.shape) != (nb, w):
        raise ValueError(f"cols {tuple(cols.shape)} != {(nb, w)}")
    _check("v", v, torch.float32, 1, dev)
    if v.shape[0] % bc:
        raise ValueError(f"len(v) = {v.shape[0]} is not a multiple of {bc}")
    if c is not None:
        _check("c", c, torch.float32, 1, dev)
        if c.shape != v.shape:
            raise ValueError(f"c {tuple(c.shape)} != v {tuple(v.shape)}")
    y = torch.empty(nb * br, dtype=torch.float32, device=dev)
    if nb == 0:
        return y.to(out_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = ELL_MV.entry()(_ptr(data), _ptr(cols), _ptr(v), _ptr(c),
                            _ptr(y), nb, w, br, bc, v.shape[0] // bc,
                            THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"ell_mv launch failed: cudaError {rc}")
    ELL_MV.launches += 1
    return y.to(out_dtype)


def ell_hvp(dataT, colsT, u, c=None, *, out_dtype=torch.float32):
    """One-pass blocked-ELL HVP on the card: y = A (c .* (A^T u)).

    dataT/colsT : the *transposed* blocked-ELL layout of A, shapes
    (ncb, WT, bc, br) / (ncb, WT). u : (nrb * br,) over A's padded row
    axis; c : optional (ncb * bc,) scale over A's padded column axis.
    Returns (nrb * br,) in ``out_dtype`` (f32 accumulation; the atomic
    scatter makes the summation order vary between runs).
    """
    dev = dataT.device
    _check_card(dev)
    _check("dataT", dataT, torch.float32, 4, dev)
    ncb, wt, bc, br = dataT.shape
    _check("colsT", colsT, torch.int32, 2, dev)
    if tuple(colsT.shape) != (ncb, wt):
        raise ValueError(f"colsT {tuple(colsT.shape)} != {(ncb, wt)}")
    _check("u", u, torch.float32, 1, dev)
    if u.shape[0] % br or u.shape[0] == 0:
        raise ValueError(f"len(u) = {u.shape[0]} is not a positive "
                         f"multiple of {br}")
    if c is not None:
        _check("c", c, torch.float32, 1, dev)
        if c.shape[0] != ncb * bc:
            raise ValueError(f"len(c) = {c.shape[0]} != {ncb * bc}")
    y = torch.zeros(u.shape[0], dtype=torch.float32, device=dev)
    if ncb == 0:
        return y.to(out_dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = ELL_HVP.entry()(_ptr(dataT), _ptr(colsT), _ptr(u), _ptr(c),
                             _ptr(y), ncb, wt, bc, br, u.shape[0] // br,
                             THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"ell_hvp launch failed: cudaError {rc}")
    ELL_HVP.launches += 1
    return y.to(out_dtype)
