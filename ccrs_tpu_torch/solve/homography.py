"""Radial-distortion homography initialization, batched over hypotheses.

Port of ``ccrs_tpu/solve/homography.py`` (the reference's RANSAC loop,
``src/optimization/homography.rs:219-262``): all hypotheses are drawn at
once — a uniform 6-subset of the observed pairs per hypothesis, by Gumbel
top-k — and solved and scored as one batch, then the best is kept.

The draws come from a ``torch.Generator``; they cannot reproduce the JAX
package's threefry draws, so ``radial_distortion_homography`` also accepts
the sample indices directly (``idx``), which the parity tests use to feed
it JAX's draws.

The 6-point minimal solver follows the radial-distortion homography of
Kukelova et al., CVPR 2015: observed points lift to (x, y, 1 + l*r^2) with
the division model; a 6x8 design matrix has a 2D null space; the lifted
transfer constraint gives a quadratic in the null-space mixing coefficient
gamma, and the last row of H plus the second distortion l' come from a 6x4
least-squares system.

``homography_to_focal`` is the closed-form focal-from-homography of
``src/util.rs:116-122``.
"""

from __future__ import annotations

import numpy as np
import torch

from .lm import cholesky_solve_batched_small


def _where_small(x, tiny):
    """x, with entries of magnitude <= tiny replaced by tiny."""
    return torch.where(x.abs() > tiny, x, torch.full_like(x, tiny))


def lift(p, l):
    """Division-model lifting (x, y) -> (x, y, 1 + l r^2)."""
    r2 = torch.sum(p * p, dim=-1)
    return torch.cat([p, (1.0 + l * r2)[..., None]], dim=-1)


def _solve_h6(p0, p1):
    """Minimal 6-point solver, batched: p0, p1 (S, 6, 2) normalized pairs.

    Returns (lam (S,), H (S, 3, 3), valid (S,))."""
    x, y = p0[..., 0], p0[..., 1]
    xp, yp = p1[..., 0], p1[..., 1]
    r2 = x * x + y * y
    rp2 = xp * xp + yp * yp
    # 6x8 design matrix; its null space encodes rows 0,1 of H and l-terms
    M = torch.stack(
        [-x * yp, -y * yp, -yp, x * xp, xp * y, xp, -r2 * yp, r2 * xp], dim=-1
    )  # (S, 6, 8)
    Q, _ = torch.linalg.qr(M.mT, mode="complete")  # (S, 8, 8)
    n0 = Q[..., :, 6]
    n1 = Q[..., :, 7]
    n02, n05, n06, n07 = n0[..., 2], n0[..., 5], n0[..., 6], n0[..., 7]
    n12, n15, n16, n17 = n1[..., 2], n1[..., 5], n1[..., 6], n1[..., 7]

    a_coef = n02 * n07 - n05 * n06
    b_minus = -n02 * n17 + n05 * n16 + n06 * n15 - n07 * n12
    disc = (
        n02 * n02 * n17 * n17
        - 2.0 * n02 * n05 * n16 * n17
        - 2.0 * n02 * n06 * n15 * n17
        - 2.0 * n02 * n07 * n12 * n17
        + 4.0 * n02 * n07 * n15 * n16
        + n05 * n05 * n16 * n16
        + 4.0 * n05 * n06 * n12 * n17
        - 2.0 * n05 * n06 * n15 * n16
        - 2.0 * n05 * n07 * n12 * n16
        + n06 * n06 * n15 * n15
        - 2.0 * n06 * n07 * n12 * n15
        + n07 * n07 * n12 * n12
    )
    ok_disc = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    den = _where_small(2.0 * a_coef, 1e-20)
    eye4 = torch.eye(4, dtype=p0.dtype, device=p0.device)

    def per_gamma(gamma):
        lden = _where_small(-gamma * n02 - n12, 1e-20)
        l = -(gamma * n06 + n16) / lden
        v1 = gamma[..., None] * n0 + n1  # (S, 8)
        # remaining row + l' from the lifted-transfer constraint
        sc = 1.0 + l[..., None] * r2
        h0_dot = v1[..., 0:1] * x + v1[..., 1:2] * y + v1[..., 2:3] * sc  # (S, 6)
        A = torch.stack([-x * xp, -xp * y, -xp * sc, rp2 * h0_dot], dim=-1)
        b = -h0_dot
        AtA = A.mT @ A + 1e-14 * eye4
        Atb = (A.mT @ b[..., None])[..., 0]
        sol = cholesky_solve_batched_small(AtA, Atb)  # (S, 4)
        H = torch.cat([v1[..., :6], sol[..., :3]], dim=-1).reshape(-1, 3, 3)
        return l, sol[..., 3], H

    l_a, lp_a, H_a = per_gamma((b_minus - sq) / den)
    l_b, lp_b, H_b = per_gamma((b_minus + sq) / den)
    valid_a = (l_a < 0.0) & (lp_a < 0.0)
    valid_b = (l_b < 0.0) & (lp_b < 0.0)

    # both valid: pick the pair with min |log10(l/l')| (most consistent)
    def consistency(l, lp):
        lp = torch.where(lp != 0, lp, torch.full_like(lp, 1e-20))
        return torch.abs(torch.log10(torch.abs(l / lp)))

    pick_a = torch.where(
        valid_a & valid_b, consistency(l_a, lp_a) < consistency(l_b, lp_b), valid_a
    )
    l = torch.where(pick_a, l_a, l_b)
    lp = torch.where(pick_a, lp_a, lp_b)
    H = torch.where(pick_a[..., None, None], H_a, H_b)
    lam = -torch.sqrt(torch.clamp(l * lp, min=0.0))
    return lam, H, ok_disc & (valid_a | valid_b)


def _score(p0, p1, mask, H, lam):
    """Average transfer distance of each hypothesis (H (S,3,3), lam (S,))
    over the masked pairs p0, p1 (N, 2) (homography.rs:169-205): lift the
    source with lam, map through H, intersect with the division-model
    circle, pick the root by the first observed pair."""
    sc = 1.0 + lam[:, None] * torch.sum(p0 * p0, dim=-1)  # (S, N)
    lifted = torch.cat([p0.expand(sc.shape + (2,)), sc[..., None]], dim=-1)
    r = lifted @ H.mT  # (S, N, 3)
    in_sqrt = torch.clamp(
        r[..., 2] * r[..., 2] - 4.0 * lam[:, None] * (r[..., 0] ** 2 + r[..., 1] ** 2),
        min=0.0,
    )
    root = torch.sqrt(in_sqrt)
    a0 = _where_small((r[..., 2] - root) / 2.0, 1e-20)
    a1 = _where_small((r[..., 2] + root) / 2.0, 1e-20)
    first = int(torch.argmax(mask.to(torch.int32)))
    d0_first = torch.abs(p1[first, 0] - r[:, first, 0] / a0[:, first])
    d1_first = torch.abs(p1[first, 0] - r[:, first, 0] / a1[:, first])
    a = torch.where((d0_first < d1_first)[:, None], a0, a1)
    d = torch.sqrt((p1[:, 0] - r[..., 0] / a) ** 2 + (p1[:, 1] - r[..., 1] / a) ** 2)
    wsum = torch.clamp(torch.sum(mask.to(p0.dtype)), min=1.0)
    return torch.sum(torch.where(mask, d, torch.zeros_like(d)), dim=-1) / wsum


def sample_subsets(mask, n_samples: int, generator: torch.Generator):
    """(n_samples, 6) indices, each row a uniform 6-subset of the observed
    pairs (Gumbel top-k over ``mask``), drawn from ``generator``."""
    u = torch.rand(
        (n_samples, mask.shape[0]), generator=generator,
        device=generator.device, dtype=torch.float64,
    ).to(mask.device)
    g = -torch.log(-torch.log(u))
    g = torch.where(mask, g, torch.full_like(g, -torch.inf))
    return torch.topk(g, 6, dim=-1).indices


def radial_distortion_homography(
    p0, p1, mask, n_samples: int = 1000, generator=None, idx=None
):
    """Batched RANSAC estimate of (lambda, H) between two frames.

    Args:
      p0, p1: (N, 2) center/half-size-normalized point pairs, aligned by
        board corner index.
      mask: (N,) bool — pair observed in both frames.
      n_samples: hypothesis count (the reference uses 1000).
      generator: draws the hypotheses (``sample_subsets``) when ``idx`` is
        not given.
      idx: optional (n_samples, 6) int64 sample indices.

    Returns (lambda, H (3, 3), best_score) as tensors.
    """
    if idx is None:
        if generator is None:
            raise ValueError("radial_distortion_homography needs generator or idx")
        idx = sample_subsets(mask, n_samples, generator)
    lam, H, valid = _solve_h6(p0[idx], p1[idx])
    score = _score(p0, p1, mask, H, lam)
    # a sample is meaningless with < 6 observed pairs (degenerate mask)
    enough = torch.sum(mask) >= 6
    score = torch.where(valid & enough, score, torch.full_like(score, torch.inf))
    best = torch.argmin(score)
    return lam[best], H[best], score[best]


def homography_to_focal_traced(H):
    """Closed-form focal from a homography (unit-plane, centered principal
    point) without host branches; returns (f, ok) as 0-d tensors."""
    h0, h1, h2 = H[0, 0], H[0, 1], H[0, 2]
    h3, h4, h5 = H[1, 0], H[1, 1], H[1, 2]
    h6, h7 = H[2, 0], H[2, 1]

    def safe_div(n, d):
        return n / _where_small(d, 1e-20)

    def pair(v1, v2, d1, d2):
        lo = torch.minimum(v1, v2)
        hi = torch.maximum(v1, v2)
        val = torch.where(
            lo > 0.0, torch.where(d1.abs() > d2.abs(), hi, lo), hi
        )
        return val, (lo > 0.0) | (hi > 0.0)

    d1a = h6 * h7
    d2a = (h7 - h6) * (h7 + h6)
    f1_sq, f1_ok = pair(
        safe_div(-(h0 * h1 + h3 * h4), d1a),
        safe_div(h0 * h0 + h3 * h3 - h1 * h1 - h4 * h4, d2a),
        d1a, d2a,
    )
    d1b = h0 * h3 + h1 * h4
    d2b = h0 * h0 + h1 * h1 - h3 * h3 - h4 * h4
    f0_sq, f0_ok = pair(
        safe_div(-h2 * h5, d1b), safe_div(h5 * h5 - h2 * h2, d2b), d1b, d2b
    )
    f1 = torch.sqrt(torch.clamp(f1_sq, min=0.0))
    f0 = torch.sqrt(torch.clamp(f0_sq, min=0.0))
    f = torch.where(
        f0_ok & f1_ok,
        torch.sqrt(torch.clamp(f0 * f1, min=0.0)),
        torch.where(f0_ok, f0, f1),
    )
    return f, f0_ok | f1_ok


def homography_to_focal(H):
    """Closed-form focal from a homography, host numpy (same math as
    src/optimization/homography.rs:274-325).  Returns (f, valid)."""
    H = np.asarray(H, dtype=np.float64)
    h0, h1, h2 = H[0]
    h3, h4, h5 = H[1]
    h6, h7 = H[2, 0], H[2, 1]

    def safe_div(n, d):
        return n / (d if abs(d) > 1e-20 else 1e-20)

    def pair(v1, v2, d1, d2):
        # both positive -> hi when |d1|>|d2| else lo; only hi positive ->
        # hi; else invalid
        lo, hi = min(v1, v2), max(v1, v2)
        if lo > 0.0:
            return (hi if abs(d1) > abs(d2) else lo), True
        return hi, hi > 0.0

    d1a = h6 * h7
    d2a = (h7 - h6) * (h7 + h6)
    f1_sq, f1_ok = pair(
        safe_div(-(h0 * h1 + h3 * h4), d1a),
        safe_div(h0 * h0 + h3 * h3 - h1 * h1 - h4 * h4, d2a),
        d1a, d2a,
    )
    d1b = h0 * h3 + h1 * h4
    d2b = h0 * h0 + h1 * h1 - h3 * h3 - h4 * h4
    f0_sq, f0_ok = pair(
        safe_div(-h2 * h5, d1b), safe_div(h5 * h5 - h2 * h2, d2b), d1b, d2b
    )
    f1 = float(np.sqrt(max(f1_sq, 0.0)))
    f0 = float(np.sqrt(max(f0_sq, 0.0)))
    if f0_ok and f1_ok:
        f = float(np.sqrt(max(f0 * f1, 0.0)))
    elif f0_ok:
        f = f0
    else:
        f = f1
    return f, (f0_ok or f1_ok)
