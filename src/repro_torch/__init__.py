"""PyTorch/CUDA port of the DiSCO solver (the JAX package ``repro`` is the
reference it is held against).

Imports ``torch`` and never ``jax``, and nothing of ``repro``. The
entry points (:func:`disco_fit`, :class:`DiscoSolver`) run on the card
unless the caller passes ``device='cpu'``. Input is a sparse
:class:`CSRMatrix` or a dense ``(d, n)`` array or tensor; on the card
every HVP of PCG, classic or s-step (``pcg_block_s > 1``), goes through
the hand-written Hopper kernels of :mod:`repro_torch.kernels` (for dense
input with ``use_kernel=True``).
"""
from repro_torch.core.disco import (DiscoConfig, DiscoResult, DiscoSolver,
                                    disco_fit)
from repro_torch.core.glm import GLMProblem
from repro_torch.data.sparse import CSRMatrix, make_sparse_glm_data
from repro_torch.data.synthetic import make_glm_data
from repro_torch.parallel.collectives import InProcessGroup

__all__ = ["DiscoConfig", "DiscoResult", "DiscoSolver", "disco_fit",
           "GLMProblem", "CSRMatrix", "make_sparse_glm_data",
           "make_glm_data", "InProcessGroup"]
