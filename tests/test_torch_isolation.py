"""The port stands alone: no JAX, nothing of the JAX package, and no
silent CPU fallback."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any import of jax now fails
    import numpy as np
    import repro_torch
    from repro_torch import (CSRMatrix, DiscoConfig, GLMProblem,
                             InProcessGroup, disco_fit, make_glm_data,
                             make_sparse_glm_data)
    import repro_torch.convert, repro_torch.kernels.sparse_hvp
    import repro_torch.kernels.glm_hvp, repro_torch.kernels.build
    X, y, _ = make_sparse_glm_data(d=48, n=80, density=0.2, seed=0)
    Xd, yd, _ = make_glm_data(d=30, n=50, seed=0)
    for partition in ("samples", "features"):
        r = disco_fit(X, y, DiscoConfig(partition=partition, tau=16,
                                        max_outer=2, ell_block_d=8,
                                        ell_block_n=8),
                      group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.w).all() and r.w.shape == (48,)
        r = disco_fit(Xd, yd, DiscoConfig(partition=partition, tau=16,
                                          max_outer=2, use_kernel=True,
                                          hvp_fused=True),
                      group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.w).all() and r.w.shape == (30,)
        assert r.grad_norms[-1] < r.grad_norms[0]
        r = disco_fit(X, y, DiscoConfig(partition=partition, tau=16,
                                        max_outer=2, ell_block_d=8,
                                        ell_block_n=8, pcg_block_s=3),
                      group=InProcessGroup(2), device="cpu")
        assert np.isfinite(r.w).all() and r.grad_norms[-1] < r.grad_norms[0]
    import torch
    assert GLMProblem.create(Xd, yd, device="cpu").grad(torch.zeros(30)).shape == (30,)
    leaked = sorted(m for m in sys.modules
                    if m == "repro" or m.startswith("repro."))
    assert not leaked, leaked
    print("ISOLATED")
""")


def test_port_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ISOLATED" in r.stdout


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[\s.])",
                        re.MULTILINE)


def test_no_jax_or_repro_imports_in_port_sources():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without ``device=`` the entry points run on the card; with no card
    they raise instead of quietly running on the CPU."""
    from repro_torch import (CSRMatrix, DiscoConfig, DiscoSolver, disco_fit,
                             make_sparse_glm_data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y, _ = make_sparse_glm_data(d=16, n=20, density=0.3, seed=0)
    cfg = DiscoConfig(tau=8, max_outer=1, ell_block_d=8, ell_block_n=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        disco_fit(X, y, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiscoSolver(X, y, cfg, device="cuda")
    assert isinstance(X, CSRMatrix)
