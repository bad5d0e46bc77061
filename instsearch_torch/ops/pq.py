"""Product quantization (PQ), the compressed-domain storage tier (port of
``instsearch_tpu/ops/pq.py``: ``PQCodebook``, ``default_m``, ``fit_pq``,
``fit_opq``, ``fit_apq``, ``encode_pq``, ``encode_apq``, ``unpack_pq``,
``decode_pq``, ``pq_lut`` and ``pq_reconstruction_mse``).

D splits into M subspaces of ds = D/M components, each vector-quantized
against 16 centroids, so a row is M 4-bit codes (32 bytes at D=512, M=64).
A query scores a row without decoding it: ``score(q, x) = sum_m
LUT_q[m, code_m(x)]`` with ``LUT_q[m, j] = q_m . C[m, j]`` (asymmetric
distance computation, ADC; the K4 kernel in ``kernels/pq_scan.py``).

The arithmetic is the reference's, so both packages fit and encode alike:
  * assignment scores bf16 rows against bf16 centroids with f32 sums and
    takes the argmin of ``||c||^2 - 2 x.c`` (``||c||^2`` in f32), the first
    index on ties;
  * a Lloyd update is the f32 mean of the bf16 rows of each cluster,
    accumulated as the reference's one-hot product (a batched matmul, so
    the sums do not depend on atomics' order on the card);
  * the initial rows and the empty-cluster respawns come from the same
    numpy generator, seeded alike.
Codes pack two per byte in the int4 row store's layout
(``ops/quantize.py``): byte j holds the code of subspace j in its low
nibble and of subspace j + M/2 in its high nibble, as ``byte = 16 * (c_hi -
8) + c_lo``.

The anisotropic (score-aware) fit, ``fit_apq`` / ``encode_apq``, is the
reference's too (the comment above ``eta_from_threshold``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .kmeans import pick_chunk


@dataclass(frozen=True)
class PQCodebook:
    """Per-subspace centroids ``[M, K, ds]`` f32; ``M * ds = D``, K = 16."""
    centroids: torch.Tensor

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def k(self) -> int:
        return self.centroids.shape[1]

    @property
    def ds(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.ds


def default_m(d: int) -> int:
    """Largest even subquantizer count <= max(2, d // 8) that divides d: the
    D/8 rule of Jegou et al. (TPAMI 2011), kept even for the nibble packing
    and dividing d for the subspaces."""
    for m in range(max(2, (d // 8) & ~1), 1, -2):
        if d % m == 0:
            return m
    raise ValueError(f"no even subquantizer count divides dim {d}")


def _check_dims(d: int, m: int) -> int:
    if m % 2:
        raise ValueError(f"m={m} must be even (codes pack two per byte)")
    if d % m:
        raise ValueError(f"descriptor dim {d} not divisible by m={m}")
    return d // m


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """bf16 rounding kept in f32: products of two such values are exact in
    f32, as in the reference's bf16 x bf16 -> f32 products."""
    return t.to(torch.bfloat16).float()


def _assign(xc: torch.Tensor, cb: torch.Tensor, cn2: torch.Tensor):
    """Nearest centroid per subspace: ``xc [c, M, ds]`` (bf16 values),
    ``cb [M, K, ds]`` (bf16 values), ``cn2 [M, K]`` -> ``(codes [M, c],
    distance minus ||x||^2 [M, c, K])``."""
    dots = torch.bmm(xc.transpose(0, 1), cb.transpose(1, 2))   # [M, c, K]
    dist = cn2[:, None, :] - 2.0 * dots
    return dist.argmin(dim=2), dist


def _pq_lloyd_iter(xs: torch.Tensor, cent: torch.Tensor, nv: int,
                   chunk: int):
    """One Lloyd iteration over all subspaces at once: ``xs [N, M, ds]``,
    ``cent [M, K, ds]`` -> ``(new centroids, counts [M, K])``. Rows at or
    past ``nv`` are padding and count nowhere. (The reference also returns
    the summed residual, which nothing reads.)"""
    n = xs.shape[0]
    m, k, _ = cent.shape
    cb = _bf16(cent)
    cn2 = (cent * cent).sum(-1)                                 # [M, K]
    sums = torch.zeros_like(cent)
    counts = torch.zeros((m, k), dtype=torch.float32, device=cent.device)
    for s in range(0, n, chunk):
        xc = _bf16(xs[s:s + chunk])                             # [c, M, ds]
        a, _ = _assign(xc, cb, cn2)                             # [M, c]
        valid = (torch.arange(s, s + xc.shape[0], device=xs.device)
                 < nv).float()
        onehot = (torch.nn.functional.one_hot(a, k).float()
                  * valid[None, :, None])                       # [M, c, K]
        sums += torch.bmm(onehot.transpose(1, 2), xc.transpose(0, 1))
        counts += onehot.sum(dim=1)
    new = torch.where(counts[..., None] > 0,
                      sums / counts.clamp(min=1)[..., None], cent)
    return new, counts.long()


def _lloyd_loop(x: torch.Tensor, cent: torch.Tensor, nv: int, iters: int,
                chunk: int, rng, k: int) -> torch.Tensor:
    """``iters`` Lloyd iterations with empty clusters respawned on fresh
    sampled rows: the core of fit_pq (cold start) and fit_opq (warm
    start after each rotation update)."""
    n, _ = x.shape
    m, _, ds = cent.shape
    xs = x.reshape(n, m, ds)
    for _ in range(iters):
        cent, counts = _pq_lloyd_iter(xs, cent, nv, chunk)
        empty = (counts == 0).cpu().numpy()                     # [M, K]
        if empty.any():
            rows = rng.choice(nv, size=k, replace=False)
            resp = x[torch.as_tensor(rows, device=x.device)].float()
            resp = resp.reshape(k, m, ds).cpu().numpy()
            cent_np = cent.cpu().numpy().copy()
            for mi, ki in zip(*np.nonzero(empty)):
                cent_np[mi, ki] = resp[ki, mi]
            cent = torch.as_tensor(cent_np, device=x.device)
    return cent


def fit_pq(x: torch.Tensor, m: int = 64, k: int = 16, *,
           num_valid: int | None = None, iters: int = 15, seed: int = 0,
           chunk: int = 16384) -> PQCodebook:
    """Fit a PQ codebook on ``x [N, D]`` (rows >= num_valid are padding),
    on x's device. K is 16 (the K4 kernel's 4-bit codes). Init: ``k`` rows
    drawn by ``numpy.random.default_rng(seed)``, one per centroid, cut into
    subspaces."""
    x = torch.as_tensor(x).float()
    n, d = x.shape
    ds = _check_dims(d, m)
    if k != 16:
        raise ValueError("PQ tier is 4-bit: k must be 16 "
                         "(kernels/pq_scan.py one-hot width)")
    nv = int(num_valid if num_valid is not None else n)
    if nv < k:
        raise ValueError(f"{nv} rows < {k} centroids")
    chunk = pick_chunk(n, chunk)
    rng = np.random.default_rng(seed)
    take = rng.choice(nv, size=k, replace=False)
    sample = x[torch.as_tensor(take, device=x.device)]          # [K, D]
    cent = sample.reshape(k, m, ds).transpose(0, 1).contiguous()
    return PQCodebook(_lloyd_loop(x, cent, nv, iters, chunk, rng, k))


def _procrustes_update(x: torch.Tensor, xhat: torch.Tensor) -> torch.Tensor:
    """Orthogonal Procrustes: ``argmin_R ||X R - X^||_F`` over orthogonal R
    is ``U V^T`` for ``X^T X^ = U S V^T``."""
    u, _, vt = torch.linalg.svd(x.T @ xhat, full_matrices=False)
    return u @ vt


def fit_opq(x: torch.Tensor, m: int = 64, k: int = 16, *,
            num_valid: int | None = None, opq_iters: int = 8,
            pq_iters: int = 15, refine_iters: int = 4, seed: int = 0,
            chunk: int = 16384) -> "tuple[torch.Tensor, PQCodebook]":
    """Optimized PQ (Ge et al., CVPR 2013, the non-parametric alternation):
    learn an orthogonal ``R [D, D]`` so PQ of ``X R`` has less
    reconstruction error. Each round encodes and decodes ``X R`` under the
    current codebook, solves R by Procrustes, and refreshes the codebook
    with ``refine_iters`` warm-started Lloyd iterations in the new space.
    Scoring rotates the query once: ``q . x = (q R) . (x R)``. Returns
    ``(rotation, PQCodebook)``."""
    x = torch.as_tensor(x).float()
    n, d = x.shape
    _check_dims(d, m)
    nv = int(num_valid if num_valid is not None else n)
    chunk = pick_chunk(n, chunk)
    rng = np.random.default_rng(seed)
    cb = fit_pq(x, m=m, k=k, num_valid=nv, iters=pq_iters, seed=seed,
                chunk=chunk)
    r = torch.eye(d, dtype=torch.float32, device=x.device)
    xr = x
    for _ in range(opq_iters):
        xhat = decode_pq(encode_pq(xr, cb, chunk=chunk), cb)
        r = _procrustes_update(x[:nv], xhat[:nv])
        xr = x @ r
        cb = PQCodebook(_lloyd_loop(xr, cb.centroids, nv, refine_iters,
                                    chunk, rng, k))
    return r, cb


def pq_reconstruction_mse(x: torch.Tensor, cb: PQCodebook,
                          rotation: "torch.Tensor | None" = None) -> float:
    """Mean squared reconstruction error of the (optionally rotated) PQ
    code of ``x``: the quantity OPQ minimizes."""
    xr = x if rotation is None else x @ rotation
    err = xr - decode_pq(encode_pq(xr, cb), cb)
    return float((err * err).sum(dim=1).mean())


def encode_pq(x: torch.Tensor, cb: PQCodebook, *,
              chunk: int = 16384) -> torch.Tensor:
    """Encode ``x [N, D]`` -> packed codes ``[N, M/2]`` int8 (the layout in
    the module docstring), in slices of ``pick_chunk(N, chunk)`` rows."""
    n, d = x.shape
    m = cb.m
    ds = _check_dims(d, m)
    if ds != cb.ds:
        raise ValueError(f"x dim {d} != codebook dim {cb.dim}")
    chunk = pick_chunk(n, chunk)
    cent = cb.centroids
    cbf, cn2 = _bf16(cent), (cent * cent).sum(-1)
    codes = torch.cat([
        _assign(_bf16(x[s:s + chunk].reshape(-1, m, ds)), cbf, cn2)[0].T
        for s in range(0, n, chunk)])                           # [N, M]
    v = codes - 8                                               # [-8, 8)
    lo, hi = v[:, :m // 2], v[:, m // 2:]
    return (16 * hi + lo + 8).to(torch.int8)


def unpack_pq(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``[N, M/2]`` int8 -> codes ``[N, M]`` int32 in [0, 16)."""
    p = packed.to(torch.int32)
    v_hi = p >> 4                       # exact: low half stored offset +8
    lo = p - 16 * v_hi                  # = v_lo + 8 in [0, 16)
    return torch.cat([lo, v_hi + 8], dim=1)


def decode_pq(packed: torch.Tensor, cb: PQCodebook) -> torch.Tensor:
    """Reconstruct ``x^ [N, D]`` f32, the inverse used by tests and by OPQ;
    scoring never decodes (ADC)."""
    codes = unpack_pq(packed).long()                            # [N, M]
    m_idx = torch.arange(cb.m, device=codes.device)[None, :]
    return cb.centroids[m_idx, codes].reshape(packed.shape[0], -1)


# Anisotropic (score-aware) PQ, Guo et al., "Accelerating Large-Scale
# Inference with Anisotropic Vector Quantization" (ScaNN), ICML 2020, as the
# reference fits it. The loss re-weights the residual component parallel to
# the datapoint, which moves the scores of exactly the queries that rank it:
#
#     l(x, x^) = ||r||^2 + (eta - 1) <r, x>^2 / ||x||^2,    r = x - x^,
#
# eta = (d - 1) T^2 / (1 - T^2) from the threshold T (Theorem 3.2, unit-norm
# data). The parallel term couples the subspaces (<r, x> = sum_m <r_m, x_m>),
# so assignment is coordinate descent over the subspaces in order, carrying
# the running sum s_i = <r_i, x_i>, and the codebook update solves, per
# (subspace, cluster), the closed-form ds x ds system
#
#     [n_k I + sum_i h_ik g_i d_i d_i^T] c
#         = sum_i h_ik y_i + sum_i h_ik g_i (s_other,i + <y_i, d_i>) d_i,
#
# subspace after subspace, so s_other follows the updated centroids. ``y`` is
# the quantized vector and ``d`` the score direction: flat PQ has y = d = x,
# IVF-PQ quantizes residuals y = x - c(x) with d = x. The reference's
# lax.scan over the subspaces is the loop over m here: the same steps, the
# f32 sums in another order.


def eta_from_threshold(t: float, d: int) -> float:
    """ScaNN's parallel/orthogonal weight ratio eta for unit-norm data at
    score threshold ``t`` (arXiv:1908.10396 Theorem 3.2); at least 1 (plain
    MSE as t -> 0)."""
    if not 0.0 <= t < 1.0:
        raise ValueError(f"anisotropic threshold t={t} must be in [0, 1)")
    return max(1.0, (d - 1) * t * t / (1.0 - t * t))


def _apq_prep(y: torch.Tensor, d_vec: torch.Tensor, m: int, eta: float):
    """The ``[M, N, ds]`` layout of the sweeps and each row's parallel
    weight ``g_i = (eta - 1) / ||d_i||^2`` (0 for a zero row: plain MSE)."""
    n, dim = y.shape
    ds = dim // m
    ym = y.float().reshape(n, m, ds).transpose(0, 1)
    dm = d_vec.float().reshape(n, m, ds).transpose(0, 1)
    dn2 = (d_vec.float() ** 2).sum(dim=1)
    gam = torch.where(dn2 > 0, (eta - 1.0) / dn2.clamp(min=1e-12),
                      torch.zeros((), device=dn2.device))
    return ym, dm, gam


def _apq_assign_sweep(ym, dm, gam, cent, codes, t):
    """One coordinate-descent assignment sweep over the subspaces in order:
    subspace j takes the centroid minimizing ``||y_j - c||^2 + g (s_other +
    <y_j - c, d_j>)^2`` given the other subspaces' current codes, so the
    total loss never rises. ``codes``/``t`` ``[M, N]``: the current codes
    and each subspace's parallel term ``<y_j - c, d_j>``. -> the new
    ``(codes [M, N] int32, t [M, N])``."""
    s = t.sum(dim=0)                                            # [N]
    codes_out, t_out = [], []
    for j in range(ym.shape[0]):
        y1, d1, c1 = ym[j], dm[j], cent[j]
        s_other = s - t[j]
        e = ((y1 * y1).sum(dim=-1)[:, None] - 2.0 * (y1 @ c1.T)
             + (c1 * c1).sum(dim=-1)[None])
        b = (y1 * d1).sum(dim=-1)[:, None] - d1 @ c1.T          # <y - c, d>
        loss = e + gam[:, None] * (s_other[:, None] + b) ** 2
        a = loss.argmin(dim=1)
        t_new = b.gather(1, a[:, None])[:, 0]
        s = s_other + t_new
        codes_out.append(a.to(torch.int32))
        t_out.append(t_new)
    return torch.stack(codes_out), torch.stack(t_out)


def _apq_update_sweep(ym, dm, gam, cent, codes, t):
    """One codebook-update sweep, subspace after subspace: for fixed codes,
    each cluster's closed-form ds x ds solve, then that subspace's parallel
    terms refreshed. An empty cluster keeps its centroid. -> ``(centroids
    [M, K, ds], t [M, N])``."""
    s = t.sum(dim=0)
    k, ds = cent.shape[1], cent.shape[2]
    eye = torch.eye(ds, dtype=torch.float32, device=cent.device)
    cents, t_out = [], []
    for j in range(ym.shape[0]):
        y1, d1, c1, a1 = ym[j], dm[j], cent[j], codes[j].long()
        s_other = s - t[j]
        h = torch.nn.functional.one_hot(a1, k).float()          # [N, K]
        nk = h.sum(dim=0)                                       # [K]
        outer = (d1 * gam[:, None])[:, :, None] * d1[:, None, :]
        a_mat = ((h.T @ outer.reshape(-1, ds * ds)).reshape(k, ds, ds)
                 + nk[:, None, None] * eye)
        # an empty cluster's system is singular (zero): give it the
        # identity, its solution is discarded below
        a_mat = a_mat + (nk == 0).float()[:, None, None] * eye
        yd = (y1 * d1).sum(dim=-1)
        rhs = h.T @ y1 + h.T @ ((gam * (s_other + yd))[:, None] * d1)
        c_new = torch.linalg.solve(a_mat, rhs[..., None])[..., 0]
        c_new = torch.where(nk[:, None] > 0, c_new, c1)
        t_new = yd - (c_new[a1] * d1).sum(dim=-1)
        s = s_other + t_new
        cents.append(c_new)
        t_out.append(t_new)
    return torch.stack(cents), torch.stack(t_out)


def _apq_loss(ym, dm, gam, cent, codes) -> torch.Tensor:
    """Mean anisotropic loss of the current (codes, centroids), the
    quantity the alternation minimizes."""
    e = torch.zeros(ym.shape[1], dtype=torch.float32, device=ym.device)
    s = torch.zeros_like(e)
    for j in range(ym.shape[0]):
        r = ym[j] - cent[j][codes[j].long()]
        e = e + (r * r).sum(dim=-1)
        s = s + (r * dm[j]).sum(dim=-1)
    return (e + gam * s * s).mean()


def fit_apq(y: torch.Tensor, m: int = 64, k: int = 16, *,
            directions: "torch.Tensor | None" = None, t: float = 0.2,
            num_valid: int | None = None, init_iters: int = 15,
            sweeps: int = 6, seed: int = 0,
            chunk: int = 16384) -> PQCodebook:
    """Fit an anisotropic PQ codebook on ``y [N, D]`` (the loss above), on
    y's device. ``directions``: each row's score direction (default ``y``:
    flat PQ; IVF-PQ passes the original rows for residual ``y``). Init: a
    plain ``fit_pq``, its MSE assignment; then ``sweeps`` alternations of
    the assignment sweep and the closed-form update. Runs over the whole
    (bounded) fit sample at once."""
    n, d = y.shape
    _check_dims(d, m)
    nv = int(num_valid if num_valid is not None else n)
    y = torch.as_tensor(y).float()[:nv]
    d_vec = y if directions is None else (
        torch.as_tensor(directions).float()[:nv])
    if d_vec.shape != y.shape:
        raise ValueError(f"directions {tuple(d_vec.shape)} != rows "
                         f"{tuple(y.shape)}")
    eta = eta_from_threshold(t, d)
    cb = fit_pq(y, m=m, k=k, iters=init_iters, seed=seed, chunk=chunk)
    ym, dm, gam = _apq_prep(y, d_vec, m, eta)
    cent = cb.centroids
    zeros = torch.zeros((m, nv), dtype=torch.float32, device=y.device)
    codes, tpar = _apq_assign_sweep(ym, dm, torch.zeros_like(gam), cent,
                                    zeros.int(), zeros)
    for _ in range(sweeps):
        codes, tpar = _apq_assign_sweep(ym, dm, gam, cent, codes, tpar)
        cent, tpar = _apq_update_sweep(ym, dm, gam, cent, codes, tpar)
    return PQCodebook(cent)


def encode_apq(y: torch.Tensor, cb: PQCodebook, *,
               directions: "torch.Tensor | None" = None, t: float = 0.2,
               sweeps: int = 2, chunk: int = 16384) -> torch.Tensor:
    """Encode ``y [N, D]`` under the loss the codebook was fitted with:
    per ``pick_chunk(N, chunk)`` rows, the MSE assignment, then ``sweeps``
    assignment sweeps; packed like :func:`encode_pq`."""
    n, d = y.shape
    m = cb.m
    _check_dims(d, m)
    eta = eta_from_threshold(t, d)
    y = torch.as_tensor(y).float()
    d_all = y if directions is None else torch.as_tensor(directions).float()
    chunk = pick_chunk(n, chunk)
    out = []
    for s0 in range(0, n, chunk):
        ym, dm, gam = _apq_prep(y[s0:s0 + chunk], d_all[s0:s0 + chunk], m,
                                eta)
        zeros = torch.zeros((m, ym.shape[1]), dtype=torch.float32,
                            device=y.device)
        codes, tpar = _apq_assign_sweep(ym, dm, torch.zeros_like(gam),
                                        cb.centroids, zeros.int(), zeros)
        for _ in range(sweeps):
            codes, tpar = _apq_assign_sweep(ym, dm, gam, cb.centroids, codes,
                                            tpar)
        out.append(codes.T)
    v = torch.cat(out) - 8
    lo, hi = v[:, :m // 2], v[:, m // 2:]
    return (16 * hi + lo + 8).to(torch.int8)


def pq_lut(q: torch.Tensor, cb: PQCodebook) -> torch.Tensor:
    """ADC lookup tables: ``q [B, D]`` -> ``[B, M, K]`` f32 with ``lut[b, m,
    j] = q[b]_m . C[m, j]``; a row with codes c scores ``sum_m lut[b, m,
    c_m]``."""
    b, d = q.shape
    ds = _check_dims(d, cb.m)
    if ds != cb.ds:
        raise ValueError(f"query dim {d} != codebook dim {cb.dim}")
    qs = q.float().reshape(b, cb.m, ds)
    return torch.einsum("bmd,mkd->bmk", qs, cb.centroids)
