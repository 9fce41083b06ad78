"""BSDF dispatch by the static override option, mirroring
``hiprt_pt_tpu.models.dispatcher`` (reference: Dispatcher.h:18-68).

  bsdf_eval(options, mats, n, wo, wi, aux)    -> (f (N,3), pdf (N,))
  bsdf_sample(options, mats, n, wo, rng, aux) -> (rng, wi, f, pdf, sample_aux)

The ``bsdf_proxy_*`` functions give RIS and ReSTIR their cheap candidate
target and sampler (models/proxy.py) through a hoisted context (``_ctx``);
``bsdf_proxy_eval`` evaluates the target without one (ReSTIR's neighbour
surfaces). The Lambertian and Oren-Nayar overrides are cheap already and
route to their real eval and sampler.
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..core.settings import BSDFOverride, RenderOptions
from . import lambert, oren_nayar, principled, proxy

_CHEAP = (BSDFOverride.LAMBERTIAN, BSDFOverride.OREN_NAYAR)


def _no_refract(n_rays, device):
    return {"refracted": torch.zeros((n_rays,), dtype=torch.bool, device=device)}


def bsdf_eval(options: RenderOptions, mats, n, wo, wi, aux=None):
    ov = options.bsdf_override
    if ov == BSDFOverride.LAMBERTIAN:
        return lambert.eval_pdf(mats.base_color, n, wo, wi)
    if ov == BSDFOverride.OREN_NAYAR:
        return oren_nayar.eval_pdf(
            mats.base_color, mats.oren_nayar_sigma, n, wo, wi)
    return principled.eval_pdf(options, mats, n, wo, wi, aux)


def bsdf_sample(options: RenderOptions, mats, n, wo, rng_state, aux=None):
    ov = options.bsdf_override
    if ov == BSDFOverride.LAMBERTIAN:
        rng_state, u1, u2 = rng_mod.next_float2(rng_state)
        wi, f, pdf = lambert.sample(mats.base_color, n, wo, u1, u2)
        return rng_state, wi, f, pdf, _no_refract(n.shape[0], n.device)
    if ov == BSDFOverride.OREN_NAYAR:
        rng_state, u1, u2 = rng_mod.next_float2(rng_state)
        wi, f, pdf = oren_nayar.sample(
            mats.base_color, mats.oren_nayar_sigma, n, wo, u1, u2)
        return rng_state, wi, f, pdf, _no_refract(n.shape[0], n.device)
    return principled.sample(options, mats, n, wo, rng_state, aux)


def bsdf_proxy_eval(options: RenderOptions, mats, n, wo, wi, aux=None):
    """Candidate target eval without a hoisted context (ReSTIR's m-terms at
    neighbour surfaces). Returns (f, pdf)."""
    if options.bsdf_override in _CHEAP:
        return bsdf_eval(options, mats, n, wo, wi, aux)
    return proxy.eval_pdf(mats, n, wo, wi)


def bsdf_proxy_ctx(options: RenderOptions, mats, n, wo):
    """The candidate-invariant proxy context of a batch of vertices, or None
    for the cheap overrides."""
    if options.bsdf_override in _CHEAP:
        return None
    return proxy.make_ctx(mats, n, wo)


def bsdf_proxy_eval_ctx(options: RenderOptions, ctx, mats, n, wo, wi, aux=None):
    """Candidate target eval: the proxy through its context, or the real
    eval of a cheap override. Returns (f, pdf)."""
    if ctx is None:
        return bsdf_eval(options, mats, n, wo, wi, aux)
    return proxy.eval_pdf_ctx(ctx, n, wo, wi)


def bsdf_proxy_sample_ctx(options: RenderOptions, ctx, mats, n, wo, rng_state,
                          aux=None):
    """Candidate direction sampler paired with bsdf_proxy_eval_ctx; its pdf
    is the exact mixture pdf. Returns (rng, wi, f, pdf)."""
    if ctx is None:
        rng_state, wi, f, pdf, _aux = bsdf_sample(options, mats, n, wo,
                                                  rng_state, aux)
        return rng_state, wi, f, pdf
    return proxy.sample_ctx(ctx, n, wo, rng_state)
