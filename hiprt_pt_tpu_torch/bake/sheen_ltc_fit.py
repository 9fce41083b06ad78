"""Sheen LTC table fitting pipeline, mirroring
``hiprt_pt_tpu.bake.sheen_ltc_fit``.

Fits the 32x32 linearly-transformed-cosine table of the sheen lobe against
a brute-force volumetric SGGX reference (Zeltner/Burley/Chiang 2022,
"Practical Multiple-Scattering Sheen Using Linearly Transformed Cosines",
reimplemented from the published model):
  * a homogeneous slab of SGGX microflakes of thickness alpha over the
    base, fiber-like flakes aligned with the normal, S = diag(s_xy, s_xy,
    alpha^2) (normal second moments);
  * unit density, single-scattering albedo 1; the extinction along w is the
    projected area sigma(w) = sqrt(w^T S w);
  * flakes reflect specularly off the sampled visible microflake normal;
  * light that reaches the base is not part of the lobe; the lobe is the
    distribution of light re-emerging from the top, and R its fraction.

Per (cos_theta_o, alpha) cell the escape directions are fitted with the LTC
the principled BSDF consumes (SheenLTC.h:24-47):
  M^-1 = [[Ai, 0, Bi], [0, Ai, 0], [0, 0, 1]],
  D(w) = cos(norm(M^-1 w))/pi * det(M^-1) / ||M^-1 w||^3,
by maximum likelihood: Adam on (log Ai, Bi), all 32 cells of an alpha row
at once.

The port draws with a ``torch.Generator`` on the device, seeded with
``seed + aj`` for alpha row aj as ``run_fit`` seeds the JAX package's keys.
Those are other draws than JAX's threefry keys, so a fitted table agrees
with the JAX package's statistically, not bit for bit. Each random step
takes its uniforms as arguments (``sggx_sample_visible``, ``slab_bounce``),
so that the tests can feed them the JAX package's own draws.

Output (32, 32, 3) f32 indexed [cos_idx, alpha_idx] = (Ai, Bi, R) at texel
centres cos_theta = (i+.5)/32, alpha = (j+.5)/32.

Run:  python -m hiprt_pt_tpu_torch.bake.sheen_ltc_fit [--paths 32768]
      [--steps 200] [--flake specular|diffuse] [--quick] [--out [PATH]]
      [--selftest] [--cpu]
(on the GPU unless --cpu; --out alone writes OUT_PATH, the port's shipped
table; without --out nothing is written).
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from ..core.device import resolve_device

OUT_PATH = os.path.join(os.path.dirname(__file__), "data_sheen_ltc.npy")
RES = 32


# --------------------------------------------------------------------------
# SGGX microflake distribution (Heitz et al. 2015) for a diagonal S
# --------------------------------------------------------------------------


def sggx_sigma(w, S):
    """Projected area sqrt(w^T S w) for diagonal S = (sx, sy, sz)."""
    sx, sy, sz = S
    return torch.sqrt(torch.clamp_min(
        sx * w[..., 0] ** 2 + sy * w[..., 1] ** 2 + sz * w[..., 2] ** 2,
        1e-20))


def sggx_ndf(wm, S):
    """SGGX normal distribution D(wm) = 1/(pi sqrt|S| (wm^T S^-1 wm)^2)."""
    sx, sy, sz = S
    det = sx * sy * sz
    q = wm[..., 0] ** 2 / sx + wm[..., 1] ** 2 / sy + wm[..., 2] ** 2 / sz
    return 1.0 / (math.pi * math.sqrt(det) * q * q)


def _onb(w):
    """Orthonormal basis (wk, wj) completing w (branchless Frisvad)."""
    s = torch.where(w[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + w[..., 2])
    b = w[..., 0] * w[..., 1] * a
    wk = torch.stack([1.0 + s * w[..., 0] ** 2 * a, s * b, -s * w[..., 0]],
                     dim=-1)
    wj = torch.stack([b, s + w[..., 1] ** 2 * a, -w[..., 1]], dim=-1)
    return wk, wj


def _normalize(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def sggx_sample_visible(u1, u2, wi, S):
    """Sample the visible-normal distribution
    D_vis(wm; wi) = <wm, wi>_+ D(wm) / sigma(wi)   [Heitz 2015, section 5]
    with the uniforms u1, u2 (the shape of wi[..., 0]).

    Projects S into the (wk, wj, wi) basis, builds the square-root factor
    of the projected matrix column by column and maps a uniform disk sample
    on the hemisphere through it."""
    wk, wj = _onb(wi)
    sx, sy, sz = S

    def quad(a, b):
        return (sx * a[..., 0] * b[..., 0] + sy * a[..., 1] * b[..., 1]
                + sz * a[..., 2] * b[..., 2])

    S_kj = quad(wk, wj)
    S_ki = quad(wk, wi)
    S_jj = quad(wj, wj)
    S_ji = quad(wj, wi)
    S_ii = quad(wi, wi)

    det = sx * sy * sz
    tmp = torch.sqrt(torch.clamp_min(S_jj * S_ii - S_ji * S_ji, 1e-20))
    inv_sqrt_Sii = 1.0 / torch.sqrt(torch.clamp_min(S_ii, 1e-20))
    zero = torch.zeros_like(tmp)
    Mk = torch.stack([math.sqrt(abs(det)) / tmp, zero, zero], dim=-1)
    Mj = torch.stack([-inv_sqrt_Sii * (S_ki * S_ji - S_kj * S_ii) / tmp,
                      inv_sqrt_Sii * tmp, zero], dim=-1)
    Mi = torch.stack([inv_sqrt_Sii * S_ki, inv_sqrt_Sii * S_ji,
                      inv_sqrt_Sii * S_ii], dim=-1)

    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    u = r * torch.cos(phi)
    v = r * torch.sin(phi)
    w = torch.sqrt(torch.clamp_min(1.0 - u * u - v * v, 0.0))

    wm_kji = _normalize(u[..., None] * Mk + v[..., None] * Mj
                        + w[..., None] * Mi)
    wm = (wm_kji[..., 0:1] * wk + wm_kji[..., 1:2] * wj
          + wm_kji[..., 2:3] * wi)
    return _normalize(wm)


def selftest_sggx_sampler(alpha=0.3, n=200_000, seed=0, device=None):
    """Check the sampler against its density: the sampled visible-normal
    mean of three test functions against an importance-reweighted
    uniform-sphere estimate of <wm,wi>+ D(wm)/sigma(wi), and that density's
    normalization. Returns the four errors."""
    dev = resolve_device(device)
    S = (1.0, 1.0, alpha * alpha)
    gen = torch.Generator(dev).manual_seed(seed)
    wi = torch.tensor([0.6, 0.0, 0.8], device=dev)
    u1 = torch.rand(n, generator=gen, device=dev)
    u2 = torch.rand(n, generator=gen, device=dev)
    wm = sggx_sample_visible(u1, u2, wi.expand(n, 3), S)
    u = torch.randn((4 * n, 3), generator=gen, device=dev)
    u = _normalize(u)
    pd = (torch.clamp_min((u * wi).sum(dim=-1), 0.0) * sggx_ndf(u, S)
          / sggx_sigma(wi, S))
    Z = pd.mean() * 4 * math.pi  # ~1 (D_vis is normalized)
    errs = [Z - 1.0]
    for f_s, f_u in ((torch.clamp_min((wm * wi).sum(dim=-1), 0.0),
                      torch.clamp_min((u * wi).sum(dim=-1), 0.0)),
                     (wm[..., 2] ** 2, u[..., 2] ** 2),
                     (wm[..., 0].abs(), u[..., 0].abs())):
        errs.append(f_s.mean() - (f_u * pd).mean() * 4 * math.pi / Z)
    return [float(e) for e in torch.stack(errs).cpu()]


# --------------------------------------------------------------------------
# Slab Monte Carlo
# --------------------------------------------------------------------------


def slab_bounce(z, w, alive, esc, out, u_t, u1, u2, S, thickness,
                flake="specular", u3=None, u4=None):
    """One step of the slab walk: free flight with the uniform u_t, escape
    through the top or loss into the base, then a scatter off the visible
    flake normal drawn with (u1, u2): a specular reflection, or for
    ``flake="diffuse"`` a cosine lobe around it drawn with (u3, u4).
    Returns the new (z, w, alive, esc, out)."""
    sig = sggx_sigma(w, S)
    t = -torch.log(torch.clamp_min(u_t, 1e-12)) / sig
    z_new = z + t * w[..., 2]
    up = w[..., 2] > 0.0
    esc_now = alive & up & (z_new >= thickness)
    lost_now = alive & ~up & (z_new <= 0.0)
    out = torch.where(esc_now[..., None], w, out)
    esc = esc | esc_now
    alive = alive & ~esc_now & ~lost_now
    z = torch.where(alive, z_new, z)
    wm = sggx_sample_visible(u1, u2, -w, S)
    if flake == "specular":
        w_next = w - 2.0 * (w * wm).sum(dim=-1, keepdim=True) * wm
    else:
        r = torch.sqrt(u3)
        ph = 2 * math.pi * u4
        loc = torch.stack([r * torch.cos(ph), r * torch.sin(ph),
                           torch.sqrt(torch.clamp_min(1 - u3, 0.0))], dim=-1)
        tk, tj = _onb(wm)
        w_next = loc[..., 0:1] * tk + loc[..., 1:2] * tj + loc[..., 2:3] * wm
    w = torch.where(alive[..., None], w_next, w)
    return z, w, alive, esc, out


def slab_walk(gen, mu_o, alpha, n_paths, max_bounces=48, s_xy=1.0,
              thickness=1.0, flake="specular"):
    """Random-walk n_paths rays through the SGGX slab for each entry cosine
    of ``mu_o`` (a tensor (C,) on the generator's device), drawing from the
    ``torch.Generator`` ``gen``.

    Entry at the top (z = thickness) heading down with cos(theta) = mu_o.
    Returns (escaped (C, n), exit_dir (C, n, 3), alive (C, n)); exit_dir is
    (0, 0, 1) where a path did not escape. Paths alive after max_bounces
    count as absorbed (the caller reports the alive share). The diffuse
    flake draws its cosine lobe with its own uniforms (the JAX package
    reuses the flake normal's, which correlates the two)."""
    dev = mu_o.device
    S = (s_xy, s_xy, alpha * alpha)
    shape = (mu_o.shape[0], n_paths)
    sin_o = torch.sqrt(torch.clamp_min(1.0 - mu_o * mu_o, 0.0))
    # the entry ray travels from the viewer into the slab; the LTC frame
    # puts the to-viewer direction at phi = 0 (+x), so the ray heads toward
    # (-x, -z)
    w = torch.stack([-sin_o, torch.zeros_like(sin_o), -mu_o],
                    dim=-1)[:, None, :].expand(*shape, 3)
    z = torch.full(shape, float(thickness), device=dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    esc = torch.zeros(shape, dtype=torch.bool, device=dev)
    out = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(*shape, 3)
    n_u = 3 if flake == "specular" else 5
    for _ in range(max_bounces):
        u = torch.rand((n_u, *shape), generator=gen, device=dev)
        z, w, alive, esc, out = slab_bounce(
            z, w, alive, esc, out, u[0], u[1], u[2], S, thickness, flake,
            *(u[3:] if flake != "specular" else ()))
    return esc, out, alive


# --------------------------------------------------------------------------
# LTC fit (maximum likelihood on escape directions)
# --------------------------------------------------------------------------


def ltc_logpdf(w, Ai, Bi):
    """log of D(w) = cos(norm(M^-1 w))/pi * det(M^-1)/||M^-1 w||^3 with
    M^-1 = [[Ai,0,Bi],[0,Ai,0],[0,0,1]] (SheenLTC.h:24-47). Ai, Bi
    broadcast against w[..., 0]."""
    wx = w[..., 0] * Ai + w[..., 2] * Bi
    wy = w[..., 1] * Ai
    wz = w[..., 2]
    # rows of zero weight must stay finite: both logs are clamped, so that
    # 0 * log never makes a NaN in the masked sum or its gradient
    l2 = torch.clamp_min(wx * wx + wy * wy + wz * wz, 1e-12)
    cos_orig = torch.clamp_min(wz, 1e-9)
    return (torch.log(cos_orig) - 0.5 * torch.log(l2) + 2.0 * torch.log(Ai)
            - 1.5 * torch.log(l2) - math.log(math.pi))


def fit_cell(esc, dirs, steps=200, lr=0.05, init=(1.0, 0.0)):
    """Adam ML fit of (Ai, Bi) to the escaped directions ``dirs`` (..., n, 3)
    weighted by ``esc`` (..., n): every leading index is a cell, fitted at
    once (a cell's loss depends only on its own parameters, so the gradient
    of the sum is each cell's own). The JAX package's Adam update: beta
    0.9 / 0.999, eps 1e-8 added to sqrt(v_hat), bias correction with
    step + 1. Returns (Ai, Bi, the final mean NLL), each of the leading
    shape."""
    esc = esc.to(torch.float32)
    wsum = torch.clamp_min(esc.sum(dim=-1), 1.0)
    dirs = dirs.detach()

    def nll(p):
        return -(esc * ltc_logpdf(dirs, torch.exp(p[..., 0:1]),
                                  p[..., 1:2])).sum(dim=-1) / wsum

    p = torch.empty((*esc.shape[:-1], 2), device=esc.device)
    p[..., 0] = math.log(init[0])
    p[..., 1] = init[1]
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for i in range(steps):
        p.requires_grad_(True)
        (g,) = torch.autograd.grad(nll(p).sum(), p)
        p = p.detach()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** (i + 1.0))
        vh = v / (1 - 0.999 ** (i + 1.0))
        p = p - lr * mh / (torch.sqrt(vh) + 1e-8)
    with torch.no_grad():
        return torch.exp(p[..., 0]), p[..., 1], nll(p)


def fit_alpha_row(gen, alpha, n_paths, flake="specular", steps=200,
                  thickness=1.0):
    """All 32 cos_theta cells of one alpha column at once, drawing from
    ``gen``. Returns (Ai, Bi, R, alive share, loss), each (32,)."""
    dev = gen.device
    mus = (torch.arange(RES, dtype=torch.float32, device=dev) + 0.5) / RES
    esc, dirs, alive = slab_walk(gen, mus, alpha, n_paths, flake=flake,
                                 thickness=thickness)
    w = esc.to(torch.float32)
    Ai, Bi, loss = fit_cell(w, dirs, steps=steps)
    return (Ai, Bi, w.sum(dim=-1) / n_paths,
            alive.sum(dim=-1) / n_paths, loss)


def run_fit(n_paths=32768, flake="specular", steps=200, seed=1234,
            verbose=True, device=None):
    """Fit the full 32x32 table on ``device`` (the GPU unless the caller
    asks for the CPU): alpha row aj draws from a generator seeded with
    seed + aj, through a slab of thickness alpha (the JAX package's
    calibration: specular flakes with T = alpha fit the reference's table
    best where its own fit is reliable)."""
    dev = resolve_device(device)
    table = np.zeros((RES, RES, 3), np.float32)
    alive_max = 0.0
    for aj in range(RES):
        alpha = float(np.float32((aj + 0.5) / RES))
        gen = torch.Generator(dev).manual_seed(seed + aj)
        Ai, Bi, R, alive, _loss = fit_alpha_row(
            gen, alpha, n_paths, flake=flake, steps=steps, thickness=alpha)
        table[:, aj] = torch.stack([Ai, Bi, R], dim=-1).cpu().numpy()
        alive_max = max(alive_max, float(alive.max()))
        if verbose:
            print(f"alpha={alpha:.3f}: R {table[0, aj, 2]:.3f}..(mu->1) "
                  f"{table[-1, aj, 2]:.3f}, Ai mid {table[16, aj, 0]:.3f}, "
                  f"truncated alive max {alive_max:.4f}", flush=True)
    return table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--paths", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--flake", default="specular",
                    choices=("specular", "diffuse"))
    ap.add_argument("--quick", action="store_true",
                    help="1/4 paths, for smoke tests")
    ap.add_argument("--out", nargs="?", const=OUT_PATH, default=None,
                    help="write the table (alone: the package's own copy)")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host (default: the GPU)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.selftest:
        errs = selftest_sggx_sampler(device=device)
        print("SGGX sampler self-test (normalization + 3 moments):", errs)
        if not all(abs(e) < 0.02 for e in errs):
            raise SystemExit(f"self-test failed: {errs}")
        print("self-test OK")
        return 0

    n_paths = args.paths // 4 if args.quick else args.paths
    table = run_fit(n_paths=n_paths, flake=args.flake, steps=args.steps,
                    device=device)
    summary = (f"{table.shape} R range [{table[..., 2].min():.4f}, "
               f"{table[..., 2].max():.4f}]")
    if args.out:
        np.save(args.out, table)
        print(f"wrote {args.out}: {summary}")
    else:
        print(f"fitted {summary} (not written: pass --out)")
    return 0


# --------------------------------------------------------------------------
# Polynomial compression of the fitted table: the principled BSDF evaluates
# (Ai, Bi, R) as Chebyshev polynomials in (cos_theta_o, alpha) instead of
# per-lane bilinear lookups; the npy table stays the ground truth. numpy, a
# copy of the JAX package's code, so the coefficients are the same.
# --------------------------------------------------------------------------

POLY_PATH = os.path.join(os.path.dirname(__file__), "data_sheen_ltc_poly.npy")
POLY_DEG = 8  # terms per axis


def sanitize_table(table: np.ndarray, r_min: float = 1e-3) -> np.ndarray:
    """Cells with R ~ 0 (no escaped MC paths — deep-grazing/low-alpha
    corner) carry meaningless (Ai, Bi); the lobe contributes R*Do ~ 0
    there, so fill them from the nearest valid cell along alpha to keep
    the field smooth for the polynomial compression."""
    out = table.copy()
    for i in range(RES):
        valid = np.nonzero(out[i, :, 2] >= r_min)[0]
        if len(valid) == 0:
            continue  # whole row dark: Ai/Bi never used at weight ~0
        for j in range(RES):
            if out[i, j, 2] < r_min:
                j_src = valid[np.argmin(np.abs(valid - j))]
                out[i, j, 0] = out[i, j_src, 0]
                out[i, j, 1] = out[i, j_src, 1]
    out[..., 1] = np.clip(out[..., 1], -2.0, 2.0)
    return out


def _cheb_basis(x: np.ndarray, deg: int) -> np.ndarray:
    """Chebyshev T_0..T_{deg-1} of x mapped from [0,1] to [-1,1]."""
    t = 2.0 * x - 1.0
    out = [np.ones_like(t), t]
    for _ in range(2, deg):
        out.append(2.0 * t * out[-1] - out[-2])
    return np.stack(out[:deg], axis=-1)


def fit_poly(table: np.ndarray, deg: int = POLY_DEG):
    """R-weighted least-squares CHEBYSHEV fit of each channel over [0,1]^2
    (cells where the lobe is dark barely constrain Ai/Bi). A monomial
    basis at this degree needs delicately cancelling O(1e4) coefficients
    that die when cast to f32 — Chebyshev keeps every coefficient O(1).

    Returns coeffs (3, deg, deg): channel c value ~=
    sum_ij coeffs[c, i, j] * T_i(2cos-1) * T_j(2alpha-1). Prints BOTH the
    f64 fit residual and the residual after the f32 cast (the shipped
    precision)."""
    table = sanitize_table(table)
    cos = (np.arange(RES) + 0.5) / RES
    alp = (np.arange(RES) + 0.5) / RES
    C, A = np.meshgrid(cos, alp, indexing="ij")
    bc = _cheb_basis(C.ravel(), deg)    # (N, deg)
    ba = _cheb_basis(A.ravel(), deg)
    basis = (bc[:, :, None] * ba[:, None, :]).reshape(-1, deg * deg)
    w_ab = np.sqrt(table[..., 2].ravel() + 0.02)
    coeffs = np.zeros((3, deg, deg), np.float32)
    for ch in range(3):
        w = w_ab if ch < 2 else np.ones_like(w_ab)
        sol, *_ = np.linalg.lstsq(
            basis * w[:, None], table[..., ch].ravel() * w, rcond=None)
        coeffs[ch] = sol.reshape(deg, deg).astype(np.float32)
        r64 = (basis @ sol - table[..., ch].ravel()) * w / w.max()
        r32 = (basis.astype(np.float32) @ coeffs[ch].ravel()
               - table[..., ch].ravel()) * w / w.max()
        print(f"sheen poly ch{ch}: f64 wrms={np.sqrt(np.mean(r64**2)):.4f} "
              f"f32 wmax={np.abs(r32).max():.4f} "
              f"wrms={np.sqrt(np.mean(r32 ** 2)):.4f}")
    return coeffs


if __name__ == "__main__":
    raise SystemExit(main())
