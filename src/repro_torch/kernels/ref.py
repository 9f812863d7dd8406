"""Plain PyTorch versions of the hand-written kernels (the contract).

Each ``ref_*`` computes what its CUDA kernel computes, with the JAX
package's oracle contract (``repro/kernels/ref.py``):

* dense GLM HVP (:mod:`repro_torch.kernels.glm_hvp`): ``ref_xt_u``,
  ``ref_x_cz``, ``ref_x_c_xt_u`` and the multi-vector ``ref_xt_multi``,
  ``ref_x_cz_multi`` and ``ref_x_c_xt_multi``; f32 or bf16 X (upcast),
  the vector operand rounded to X's dtype where the TPU kernel rounds it
  (ROADMAP F10; the one-pass versions are the two-pass chains, so they
  round u at entry and c .* z between the passes, as K5 and K10 do);
  the one-pass kernels' hand-off ``ref_dense_handoff`` and its slack; and
  the JAX oracles ``ref_glm_hvp``, ``ref_glm_hvp_multi`` of the whole
  product, which round nothing;
* blocked ELL (:mod:`repro_torch.kernels.sparse_hvp`): padding slots
  (``cols = 0``, zero tile) gather the real vector block 0 and multiply
  it by zeros, products accumulate in f32, and the result is
  ``out_dtype`` (f32 by default); f32 or bf16 tiles, the vector operand
  of each tile product rounded to the tile dtype where the TPU kernel
  rounds it (ROADMAP F10: the JAX oracle does not);
* attention (:mod:`repro_torch.kernels.flash_attention`):
  ``flash_attention_ref`` is the flash kernel's own function, and
  ``ref_attention`` ports the JAX package's attention oracle. The two
  line positions up differently and agree only when S == T.

The CPU tests and the port's CPU path run these; ``chip_smoke.py`` holds
the kernels against them on the card.
"""
from __future__ import annotations

import torch


def ref_xt_u(X, u):
    """z = X^T u   (DiSCO-F's one communicated n-vector, pre-all-reduce).

    At bf16 X, ``u`` is rounded to bf16 first, as the TPU kernel's
    ``u.astype(X.dtype)`` (``repro/kernels/glm_hvp.py::xt_u``); every
    product is then exact in f32. At f32 this is ``X.T @ u``."""
    return X.float().T @ _round_to(u, X.dtype)


def ref_x_cz(X, cz):
    """y = X @ cz  (second half of the HVP chain; the kernel fuses c).

    At bf16 X, ``cz`` (c .* z, or z alone) is rounded to bf16 first, as
    the TPU kernel's ``(c * z).astype(x.dtype)``."""
    return X.float() @ _round_to(cz, X.dtype)


def ref_xt_multi(X, U):
    """Z = X^T U   (multi-vector pass A: s probe vectors at once; at bf16
    X, U rounded to bf16 first, as the TPU kernel's ``U.astype``)."""
    return X.float().T @ _round_to(U, X.dtype)


def ref_x_cz_multi(X, c, Z):
    """Y = X (c .* Z)  (multi-vector pass B; ``c`` (n,) scales the rows
    of Z (n, s), and None means no scale). At bf16 X, c .* Z (Z alone
    without c) is rounded to bf16 first, as the TPU kernel's
    ``(c * z).astype(x.dtype)``."""
    return X.float() @ _round_to(Z if c is None else c[:, None] * Z,
                                 X.dtype)


def ref_glm_hvp(X, c, u, lam, n_global=None):
    """GLM Hessian-vector product  H u = X diag(c) X^T u / n + lam u
    (the JAX oracle ``repro.kernels.ref.ref_glm_hvp``).

    X (d, n) f32 or bf16, c (n,), u (d,). Like the oracle (whose
    ``X_bf16 @ u`` promotes) it upcasts X and rounds no vector, so at bf16
    it is the plain dense layout's product, not the kernels' (F10)."""
    n = X.shape[1] if n_global is None else n_global
    Xf = X.float()
    return Xf @ (c * (Xf.T @ u)) / n + lam * u


def ref_glm_hvp_multi(X, c, U, lam, n_global=None):
    """Batched GLM HVP  H U = X diag(c) X^T U / n + lam U  over U (d, s)
    (the JAX oracle ``repro.kernels.ref.ref_glm_hvp_multi``; X upcast, no
    vector rounded, as :func:`ref_glm_hvp`)."""
    n = X.shape[1] if n_global is None else n_global
    Xf = X.float()
    return Xf @ (c[:, None] * (Xf.T @ U)) / n + lam * U


def ref_x_c_xt_u(X, c, u):
    """Fused one-pass HVP core  y = X (c .* (X^T u)).

    Exactly the two-pass chain ``ref_x_cz(X, c * ref_xt_u(X, u))``: the
    fused kernel changes the dataflow (one read of X), not the math.
    """
    return ref_x_cz(X, c * ref_xt_u(X, u))


def ref_x_c_xt_multi(X, c, U):
    """Fused one-pass multi-vector HVP core  Y = X (c .* (X^T U)).

    Exactly the two-pass chain ``ref_x_cz_multi(X, c, ref_xt_multi(X, U))``,
    as :func:`ref_x_c_xt_u` is for one vector; ``c`` None means no scale.
    """
    return ref_x_cz_multi(X, c, ref_xt_multi(X, U))


def ref_dense_handoff(X, c, U):
    """The one-pass dense HVP's hand-off before its rounding:
    ``c .* (X^T U)`` in f32, (n,) for a vector u (d,) and (n, s) for U
    (d, s), pass A rounding U to X's dtype as :func:`ref_xt_u` does
    (``c`` None: z alone). The bf16 instances of ``x_c_xt_u`` and
    ``x_c_xt_multi`` round it to bf16 (their ``cz_out``), after a sum of
    z in another f32 order than this one, so an element within f32
    rounding of a bf16 tie may round either way (ROADMAP F11): checks
    compare the two halves (:func:`dense_handoff_flips` with
    :func:`dense_handoff_slack`)."""
    if U.dim() == 1:
        z = ref_xt_u(X, U)
        return z if c is None else c * z
    Z = ref_xt_multi(X, U)
    return Z if c is None else c[:, None] * Z


def dense_handoff_slack(X, c, U, t):
    """Per element of an unrounded dense hand-off ``t``
    (:func:`ref_dense_handoff` of these operands), the most that two f32
    summation orders of its d products can put between their results:
    2 gamma_d (gamma_d = d u / (1 - d u), u = 2^-24) times the sum of the
    products' magnitudes sum |x| |u| (times |c|), plus the rounding of
    the product by c in each."""
    d = X.shape[0]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    mag = ref_dense_handoff(X.abs(), None if c is None else c.abs(),
                            U.abs())
    return 2 * gamma * mag + 2.0 ** -23 * t.abs()


def dense_handoff_flips(cz, t, slack) -> tuple[int, bool]:
    """A bf16 one-pass dense kernel's rounded hand-off ``cz`` against an
    unrounded one ``t`` (the plain version's, or the two-pass pair's):
    the number of elements where ``cz`` is not ``t``'s bf16 rounding, and
    whether the hand-off agrees: ``cz`` holds bf16 values, each the bf16
    rounding of some value within ``slack`` (:func:`dense_handoff_slack`)
    of ``t`` (between the roundings of ``t - slack`` and ``t + slack``).
    Near a bf16 tie that is the other neighbour; where the d products
    cancel (|t| far below their magnitudes) two f32 orders may be several
    bf16 steps of the small result apart, which :func:`ell_handoff_flips`'
    one step does not allow (ROADMAP F11). How often such elements differ
    is a rate, held over a whole check's calls by
    :func:`handoff_rate_ok`: one call of a few hundred elements may see
    two where the rate is a few in ten thousand."""
    cz = cz.reshape(t.shape)
    bf = torch.bfloat16
    lo = (t - slack).to(bf).float()
    hi = (t + slack).to(bf).float()
    flips = int((cz != t.to(bf).float()).sum())
    inside = bool(((cz >= lo) & (cz <= hi)).all())
    return flips, bool(torch.equal(cz.to(bf).float(), cz)) and inside


def handoff_rate_ok(flips: int, numel: int) -> bool:
    """Whether ``flips`` hand-off elements rounded the other way, of
    ``numel`` over a check's calls, stay at most one in a thousand (plus
    one): a wrong rounding would miss about half."""
    return flips <= 1 + numel // 1000


def ref_softmax_probs(A):
    """Row-stochastic class probabilities ``P = softmax(A)`` over the
    trailing (class) axis with the max shift (A : (n, K) margins ``X^T
    W``), as ``repro.kernels.ref.ref_softmax_probs``."""
    A = A - torch.amax(A, dim=-1, keepdim=True)
    E = torch.exp(A)
    return E / torch.sum(E, dim=-1, keepdim=True)


def ref_softmax_coupling(P, V, weights=None):
    """Softmax class coupling ``S = P .* V - P .* rowsum(P .* V)``: the
    (n, K) term between the multi-vector pass A (``V = X^T U``) and pass B
    (``X S``); ``weights`` (n,) optionally masks padded samples. ``V`` may
    also be (n, K, s), s stacked directions, each coupled by the same
    (n, K) ``P``."""
    if V.dim() == 3:
        P = P[:, :, None]
    PV = P * V
    S = PV - P * torch.sum(PV, dim=1, keepdim=True)
    if weights is not None:
        S = weights.reshape(-1, *[1] * (S.dim() - 1)) * S
    return S


def ref_softmax_hvp(X, P, U, lam, n_global=None, weights=None):
    """Multinomial softmax Hessian product on stacked directions,
    ``H U = X S / n + lam U`` with ``S`` the class coupling of ``V = X^T
    U``; X (d, n), P (n, K) probabilities, U (d, K)."""
    n = X.shape[1] if n_global is None else n_global
    V = X.T @ U
    S = ref_softmax_coupling(P, V, weights)
    return X @ S / n + lam * U


def _round_to(x, dtype):
    """``x`` rounded to the tile dtype and back to f32: the identity for
    f32 tiles, round to nearest even for bf16 (as the TPU kernels'
    ``astype``)."""
    return x.to(dtype).float()


def ref_ell_mv(data, cols, v, c=None, out_dtype=torch.float32, *,
               sched=None):
    """Blocked-ELL generalized matvec  y = A (c .* v).

    data : (nb, W, br, bc) tiles, cols : (nb, W) column-block indices,
    v/c  : (ncb * bc,) padded vectors -> (nb * br,) in ``out_dtype``.
    ``sched`` (the kernel's live-tile schedule) is ignored: every slot is
    read, and the slots past a row-block's live ones hold zero tiles.

    ``c .* v`` is rounded to the tile dtype before the products, where the
    TPU kernel rounds it (``cv = (c * v).astype(x.dtype)``,
    ``repro/kernels/sparse_hvp.py::_ell_mv_kernel``): at bf16 tiles every
    product is then exact in f32, and the sums are f32; at f32 nothing
    changes. The JAX oracle ``repro.kernels.ref.ref_ell_mv`` multiplies by
    the unrounded vector, so at bf16 it misses the TPU kernel (ROADMAP
    F10); this follows the kernel.
    """
    nb, w, br, bc = data.shape
    vv = _round_to(v if c is None else c * v, data.dtype)
    g = vv.reshape(-1, bc)[cols.long()]                # (nb, W, bc)
    y = torch.einsum("iwab,iwb->ia", data.float(), g.float())
    return y.reshape(nb * br).to(out_dtype)


def ref_ell_mm(data, cols, V, c=None, out_dtype=torch.float32, *,
               sched=None):
    """Blocked-ELL generalized matmat  Y = A (c[:, None] .* V).

    V : (ncb * bc, s) -> (nb * br, s) in ``out_dtype``; the multi-vector
    version of :func:`ref_ell_mv` (the s-step sparse HVP round), rounding
    ``c .* V`` to the tile dtype as it does (the TPU kernel's
    ``_ell_mm_kernel``); ``sched`` is ignored, as there.
    """
    nb, w, br, bc = data.shape
    s = V.shape[1]
    VV = _round_to(V if c is None else c[:, None] * V, data.dtype)
    g = VV.reshape(-1, bc, s)[cols.long()]             # (nb, W, bc, s)
    y = torch.einsum("iwab,iwbs->ias", data.float(), g.float())
    return y.reshape(nb * br, s).to(out_dtype)


def ref_ell_hvp_t(dataT, colsT, u, c=None, out_dtype=torch.float32, *,
                  sched=None):
    """One-pass ELL HVP  y = A (c .* (A^T u))  from the transposed layout.

    Pass A is :func:`ref_ell_mv` on the transposed layout; pass B
    contracts each tile against its scaled z block and scatter-adds into
    the output row-blocks. u : (nrb * br,), returns the same length.
    ``sched`` (the kernel's step schedule) is ignored: every slot is read.

    Rounding as the TPU kernel's (``_ell_hvp_kernel``): ``u`` goes to the
    tile dtype at entry (pass A is :func:`ref_ell_mv`, which rounds it),
    and ``c .* z`` between the passes; the JAX oracle rounds neither
    (ROADMAP F10).
    """
    ncb, wt, bc, br = dataT.shape
    nrb = u.shape[0] // br
    z = ref_ell_mv(dataT, colsT, u)                    # (ncb * bc,)
    cz = _round_to(z if c is None else c * z, dataT.dtype)
    g = cz.reshape(ncb, bc)
    contrib = torch.einsum("jwab,ja->jwb", dataT.float(), g)
    y = torch.zeros((nrb, br), dtype=torch.float32, device=u.device)
    y.index_add_(0, colsT.reshape(-1).long(), contrib.reshape(-1, br))
    return y.reshape(nrb * br).to(out_dtype)


def ref_ell_hvp_mm_t(dataT, colsT, U, c=None, out_dtype=torch.float32, *,
                     sched=None):
    """Multi-vector twin of :func:`ref_ell_hvp_t`: U (nrb * br, s) ->
    Y = A (c .* (A^T U)) of the same shape, ``U`` and ``c .* Z`` rounded
    to the tile dtype as there (``_ell_hvp_mm_kernel``); ``sched`` is
    ignored, as there."""
    CZ = _round_to(ref_ell_handoff_t(dataT, colsT, U, c), dataT.dtype)
    return ref_ell_scatter_t(dataT, colsT, CZ, U.shape[0]).to(out_dtype)


def ref_ell_handoff_t(dataT, colsT, U, c=None):
    """The one-pass HVP's hand-off before its rounding: ``c .* (A^T U)``
    in f32, (ncb * bc, s) for U (nrb * br, s), pass A rounding ``U`` as
    :func:`ref_ell_mm` does. The kernels round it to the tile dtype into
    their ``cz`` buffer (``sparse_hvp.ell_hvp(cz_out=)``); at bf16 an
    element within f32 rounding of a bf16 tie may round either way in two
    summation orders (ROADMAP F11), so checks compare the two halves."""
    Z = ref_ell_mm(dataT, colsT, U)                    # (ncb * bc, s)
    return Z if c is None else c[:, None] * Z


def ell_handoff_slack(dataT, colsT, U, c, t):
    """Per element of an unrounded hand-off ``t`` (:func:`ref_ell_handoff_t`
    of these operands), the most that two f32 summation orders of its
    n = W * C products can put between their results: 2 gamma_n (the
    standard bound n u / (1 - n u), u = 2^-24) times the products'
    magnitudes (times |c|), plus the rounding of the product by c in
    each."""
    n = dataT.shape[1] * dataT.shape[3]
    gamma = n * 2.0 ** -24 / (1 - n * 2.0 ** -24)
    mag = ref_ell_handoff_t(dataT.abs(), colsT, U.abs(),
                            None if c is None else c.abs())
    return 2 * gamma * mag + 2.0 ** -23 * t.abs()


def ell_handoff_flips(cz, t, slack) -> tuple[int, bool]:
    """A bf16 fused kernel's rounded hand-off ``cz`` against an unrounded
    one ``t`` (the plain version's, or the two-pass pair's): the number of
    elements where ``cz`` is not ``t``'s bf16 rounding, and whether the
    hand-off agrees: ``cz`` holds bf16 values, and each element that
    differs is the other bf16 neighbour of a tie that ``t`` lies within
    ``slack`` (:func:`ell_handoff_slack`) of, at most one element in a
    thousand (a wrong rounding would miss about half). Two f32 summation
    orders may round such an element either way (ROADMAP F11)."""
    cz = cz.reshape(t.shape)
    plain = t.to(torch.bfloat16).float()
    diff = cz != plain
    a, b = cz[diff], plain[diff]
    bits = lambda x: x.to(torch.bfloat16).view(torch.int16).int()
    adjacent = ((bits(a) - bits(b)).abs() == 1) & ((a > 0) == (b > 0))
    near = (t[diff] - (a + b) / 2).abs() <= slack.reshape(t.shape)[diff]
    flips = int(diff.sum())
    return flips, (bool(torch.equal(cz.to(torch.bfloat16).float(), cz))
                   and bool((adjacent & near).all())
                   and flips <= 1 + t.numel() // 1000)


def ref_ell_scatter_t(dataT, colsT, CZ, n_rows):
    """The one-pass HVP's pass B from the transposed layout on a given
    hand-off: Y = A CZ, CZ (ncb * bc, s) -> (n_rows, s) f32, each tile
    contracted against its block of CZ and scatter-added into the output
    row-blocks."""
    ncb, wt, bc, br = dataT.shape
    s = CZ.shape[1]
    g = CZ.reshape(ncb, bc, s)
    contrib = torch.einsum("jwab,jas->jwbs", dataT.float(), g)
    y = torch.zeros((n_rows // br, br, s), dtype=torch.float32,
                    device=CZ.device)
    y.index_add_(0, colsT.reshape(-1).long(), contrib.reshape(-1, br, s))
    return y.reshape(n_rows, s)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30          # the flash kernel's mask value (never -inf: no NaN)


def _repeat_kv(k, group):
    """GQA: kv-head j serves q-heads j * group .. (j + 1) * group - 1."""
    return k if group == 1 else k.repeat_interleave(group, dim=1)


def flash_attention_ref(q, k, v, causal=True, window=0, scale=None,
                        kv_len=None):
    """What the flash kernel computes (``repro/kernels/flash_attention.py``
    ``_flash_kernel``), in one pass over the whole score matrix.

    q : (B, Hq, S, Dh), k/v : (B, Hkv, T, Dh), Hq % Hkv == 0. Positions
    run from 0 for q and k alike (``diff = q_pos - k_pos``); keys at or
    past ``kv_len`` (default T) are never attended; ``causal`` keeps
    diff >= 0 and ``window > 0`` keeps diff < window. Scores, softmax
    statistics and the sum run in f32; the denominator is floored at
    1e-30, so a row with no key to attend is 0. Returns q.dtype.
    """
    B, Hq, S, Dh = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    kv_len = T if kv_len is None else kv_len
    scale = Dh ** -0.5 if scale is None else scale
    kf = _repeat_kv(k.float(), Hq // Hkv)
    vf = _repeat_kv(v.float(), Hq // Hkv)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)).mul_(scale)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    diff = q_pos - k_pos
    mask = (k_pos < kv_len).expand(S, T)
    if causal:
        mask = mask & (diff >= 0)
    if window > 0:
        mask = mask & (diff < window)
    s.masked_fill_(~mask, NEG_INF)
    p = s.sub_(s.amax(-1, keepdim=True)).exp_().masked_fill_(~mask, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min_(1e-30)
    return (torch.matmul(p, vf) / l).to(q.dtype)


def ref_attention(q, k, v, causal=True, window=0, scale=None):
    """Masked multi-head attention oracle (``repro/kernels/ref.py``
    ``ref_attention``).

    q : (B, Hq, S, Dh), k/v : (B, Hkv, T, Dh); GQA by head repetition.
    The last q lines up with the last k (``diff = q_pos + (T - S) -
    k_pos``); window > 0 adds diff < window. Masked logits are -inf, so a
    row with no key to attend is NaN, as in the JAX oracle. Softmax in
    f32 whatever the input dtype.
    """
    B, Hq, S, Dh = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    kf = _repeat_kv(k.float(), Hq // Hkv)
    vf = _repeat_kv(v.float(), Hq // Hkv)
    scale = Dh ** -0.5 if scale is None else scale
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * scale
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    diff = (q_pos + (T - S)) - k_pos
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window and window > 0:
        mask &= diff < window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    return torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)
