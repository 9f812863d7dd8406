"""PyTorch/CUDA port of the DiSCO solver (the JAX package ``repro`` is the
reference it is held against).

Imports ``torch`` and never ``jax``, and nothing of ``repro``. The
entry points (:func:`disco_fit`, :class:`DiscoSolver`) run on the card
unless the caller passes ``device='cpu'``; every product with the data
matrix goes through the hand-written Hopper kernels of
:mod:`repro_torch.kernels`.
"""
from repro_torch.core.disco import (DiscoConfig, DiscoResult, DiscoSolver,
                                    disco_fit)
from repro_torch.data.sparse import CSRMatrix, make_sparse_glm_data
from repro_torch.parallel.collectives import InProcessGroup

__all__ = ["DiscoConfig", "DiscoResult", "DiscoSolver", "disco_fit",
           "CSRMatrix", "make_sparse_glm_data", "InProcessGroup"]
