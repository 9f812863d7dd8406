"""Build and launch machinery shared by every hand-written CUDA kernel.

Each kernel is one source in ``csrc/``, compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C entry point
(``<name>_launch``) and called through ctypes on PyTorch's current
stream. The libraries are built at first use (or by :func:`build_kernels`,
one ``nvcc`` per source, all started together) into ``build/torch_ext/``
at the repository root, named by a hash of the source, the local headers
it includes and the flags, so an edited kernel is rebuilt. A failed build
raises; nothing here falls back to the plain versions in
:mod:`repro_torch.kernels.ref`.

The kernels, and the modules whose wrappers launch them:

  ell_mv, ell_hvp, ell_mm, ell_hvp_mm      :mod:`repro_torch.kernels.sparse_hvp`
  xt_u, x_cz, x_c_xt_u, xt_multi, x_cz_multi
                                           :mod:`repro_torch.kernels.glm_hvp`

The multi-vector kernels (``ell_mm``, ``ell_hvp_mm``, ``xt_multi``,
``x_cz_multi``) take 1 to :data:`MAX_COLS` vectors per launch.

Each wrapper adds one to its kernel's ``launches`` count when it launches
the kernel and nowhere else, so a run can show that it went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 600
MAX_COLS = 8     # kern::kMaxCols in csrc/common.cuh
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(path: Path) -> list[Path]:
    """The ``csrc/`` headers a source includes, directly or through other
    headers, in first-seen order."""
    seen: list[Path] = []
    todo = [path]
    while todo:
        for name in _INCLUDE.findall(todo.pop(0).read_text()):
            header = CSRC / name
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


class CudaKernel:
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
        for p in (self.source, *local_includes(self.source)):
            h.update(p.name.encode())
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

    def launch(self, *args) -> None:
        """Call the entry point; raise on a nonzero cudaError, else count
        the launch."""
        rc = self.entry()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {rc}")
        self.launches += 1


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (tiles, cols, vector, c, y, n_blocks, W, rows, cols-per-tile,
#  n_out_blocks, threads, stream)
ELL_MV = CudaKernel("ell_mv", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _I, _P])
ELL_HVP = CudaKernel("ell_hvp", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _P])
# (X, ld, u, z, part, d, n, slices, threads, stream)
XT_U = CudaKernel("xt_u", [_P, _L, _P, _P, _P, _I, _I, _I, _I, _P])
# (X, ld, c, z, y, d, n, threads, stream)
X_CZ = CudaKernel("x_cz", [_P, _L, _P, _P, _P, _I, _I, _I, _P])
# (X, ld, c, u, y, part, d, n, bn, grid, threads, stream)
X_C_XT_U = CudaKernel("x_c_xt_u", [_P, _L, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P])
# (tiles, cols, V, ldv, c, Y, n_blocks, W, rows, cols-per-tile,
#  n_in_blocks, s, threads, stream)
ELL_MM = CudaKernel("ell_mm", [_P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                               _I, _I, _P])
ELL_HVP_MM = CudaKernel("ell_hvp_mm", [_P, _P, _P, _L, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _I, _P])
# (X, ld, U, ldu, Z, part, d, n, s, slices, threads, stream)
XT_MULTI = CudaKernel("xt_multi", [_P, _L, _P, _L, _P, _P, _I, _I, _I, _I,
                                   _I, _P])
# (X, ld, c, Z, ldz, Y, d, n, s, threads, stream)
X_CZ_MULTI = CudaKernel("x_cz_multi", [_P, _L, _P, _P, _L, _P, _I, _I, _I,
                                       _I, _P])
KERNELS = (ELL_MV, ELL_HVP, XT_U, X_CZ, X_C_XT_U, ELL_MM, ELL_HVP_MM,
           XT_MULTI, X_CZ_MULTI)


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


def check_tensor(name, t, dtype, ndim, device):
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


def check_columns(name, M, rows, device) -> tuple[int, int]:
    """Check a row-major f32 (rows, s) block of 1 to :data:`MAX_COLS`
    columns on ``device`` (any row stride, such as the first s columns of
    a wider basis); return (s, row stride)."""
    if not isinstance(M, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if M.device != device:
        raise ValueError(f"{name} is on {M.device}, expected {device}")
    if M.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {M.dtype}")
    if M.dim() != 2 or M.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, s), got {tuple(M.shape)}")
    s = M.shape[1]
    if not 1 <= s <= MAX_COLS:
        raise ValueError(f"{name} has {s} columns; the multi-vector kernels "
                         f"take 1 to {MAX_COLS} per launch")
    if s > 1 and M.stride(1) != 1:
        raise ValueError(f"{name} must be row-major ({name}.stride(1) == 1)")
    ld = M.stride(0) if rows > 1 else s
    if ld < s:
        raise ValueError(f"{name}'s row stride {ld} is shorter than a row "
                         f"({s})")
    return s, ld


def check_card(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {device}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"{torch.cuda.get_device_name(device)} is "
                           f"sm_{cap[0]}{cap[1]}")


def ptr(t):
    return None if t is None else t.data_ptr()


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entry points take
    it."""
    return torch.cuda.current_stream(device).cuda_stream
