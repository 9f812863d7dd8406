"""Plain PyTorch versions of the hand-written kernels (the contract).

Each ``ref_*`` computes what its CUDA kernel computes, with the JAX
package's oracle contract (``repro/kernels/ref.py``):

* dense GLM HVP (:mod:`repro_torch.kernels.glm_hvp`): ``ref_xt_u``,
  ``ref_x_cz``, ``ref_x_c_xt_u`` and the multi-vector ``ref_xt_multi``
  and ``ref_x_cz_multi``;
* blocked ELL (:mod:`repro_torch.kernels.sparse_hvp`): padding slots
  (``cols = 0``, zero tile) gather the real vector block 0 and multiply
  it by zeros, products accumulate in f32, and the result is
  ``out_dtype`` (f32 by default).

The CPU tests and the port's CPU path run these; ``chip_smoke.py`` holds
the kernels against them on the card.
"""
from __future__ import annotations

import torch


def ref_xt_u(X, u):
    """z = X^T u   (DiSCO-F's one communicated n-vector, pre-all-reduce)."""
    return X.T @ u


def ref_x_cz(X, cz):
    """y = X @ cz  (second half of the HVP chain; the kernel fuses c)."""
    return X @ cz


def ref_xt_multi(X, U):
    """Z = X^T U   (multi-vector pass A: s probe vectors at once)."""
    return X.T @ U


def ref_x_cz_multi(X, c, Z):
    """Y = X (c .* Z)  (multi-vector pass B; ``c`` (n,) scales the rows
    of Z (n, s), and None means no scale)."""
    return X @ (Z if c is None else c[:, None] * Z)


def ref_x_c_xt_u(X, c, u):
    """Fused one-pass HVP core  y = X (c .* (X^T u)).

    Exactly the two-pass chain ``ref_x_cz(X, c * ref_xt_u(X, u))``: the
    fused kernel changes the dataflow (one read of X), not the math.
    """
    return ref_x_cz(X, c * ref_xt_u(X, u))


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


def ref_ell_mm(data, cols, V, c=None, out_dtype=torch.float32):
    """Blocked-ELL generalized matmat  Y = A (c[:, None] .* V).

    V : (ncb * bc, s) -> (nb * br, s) in ``out_dtype``; the multi-vector
    version of :func:`ref_ell_mv` (the s-step sparse HVP round).
    """
    nb, w, br, bc = data.shape
    s = V.shape[1]
    VV = V if c is None else c[:, None] * V
    g = VV.reshape(-1, bc, s)[cols.long()]             # (nb, W, bc, s)
    y = torch.einsum("iwab,iwbs->ias", data.float(), g.float())
    return y.reshape(nb * br, s).to(out_dtype)


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


def ref_ell_hvp_mm_t(dataT, colsT, U, c=None, out_dtype=torch.float32):
    """Multi-vector twin of :func:`ref_ell_hvp_t`: U (nrb * br, s) ->
    Y = A (c .* (A^T U)) of the same shape."""
    ncb, wt, bc, br = dataT.shape
    s = U.shape[1]
    nrb = U.shape[0] // br
    Z = ref_ell_mm(dataT, colsT, U)                    # (ncb * bc, s)
    CZ = Z if c is None else c[:, None] * Z
    g = CZ.reshape(ncb, bc, s).float()
    contrib = torch.einsum("jwab,jas->jwbs", dataT.float(), g)
    y = torch.zeros((nrb, br, s), dtype=torch.float32, device=U.device)
    y.index_add_(0, colsT.reshape(-1).long(), contrib.reshape(-1, br, s))
    return y.reshape(nrb * br, s).to(out_dtype)
