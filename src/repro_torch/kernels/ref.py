"""Plain PyTorch versions of the blocked-ELL kernels (the contract).

Each ``ref_*`` computes what its CUDA kernel in
:mod:`repro_torch.kernels.sparse_hvp` computes, with the JAX package's
oracle contract: padding slots (``cols = 0``, zero tile) gather the real
vector block 0 and multiply it by zeros, products accumulate in f32, and
the result is ``out_dtype`` (f32 by default). The CPU tests run these;
``chip_smoke.py`` holds the kernels against them on the card.
"""
from __future__ import annotations

import torch


def ref_ell_mv(data, cols, v, c=None, out_dtype=torch.float32):
    """Blocked-ELL generalized matvec  y = A (c .* v).

    data : (nb, W, br, bc) tiles, cols : (nb, W) column-block indices,
    v/c  : (ncb * bc,) padded vectors -> (nb * br,) in ``out_dtype``.
    """
    nb, w, br, bc = data.shape
    vv = v if c is None else c * v
    g = vv.reshape(-1, bc)[cols.long()]                # (nb, W, bc)
    y = torch.einsum("iwab,iwb->ia", data.float(), g.float())
    return y.reshape(nb * br).to(out_dtype)


def ref_ell_hvp_t(dataT, colsT, u, c=None, out_dtype=torch.float32):
    """One-pass ELL HVP  y = A (c .* (A^T u))  from the transposed layout.

    Pass A is :func:`ref_ell_mv` on the transposed layout; pass B
    contracts each tile against its scaled z block and scatter-adds into
    the output row-blocks. u : (nrb * br,), returns the same length.
    """
    ncb, wt, bc, br = dataT.shape
    nrb = u.shape[0] // br
    z = ref_ell_mv(dataT, colsT, u)                    # (ncb * bc,)
    cz = z if c is None else c * z
    g = cz.reshape(ncb, bc).float()
    contrib = torch.einsum("jwab,ja->jwb", dataT.float(), g)
    y = torch.zeros((nrb, br), dtype=torch.float32, device=u.device)
    y.index_add_(0, colsT.reshape(-1).long(), contrib.reshape(-1, br))
    return y.reshape(nrb * br).to(out_dtype)
