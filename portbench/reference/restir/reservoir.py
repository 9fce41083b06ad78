"""ReSTIR DI reservoirs, mirroring ``hiprt_pt_tpu.restir.reservoir``
(reference: Reservoir.h:37-170).

A reservoir is a struct of (N,) tensors, one per pixel; every update and
combine is a masked select over the whole wavefront and returns a new
reservoir. The stored sample is a light point (world position, normal,
radiance and an envmap-direction flag). Each update or combine draws one PCG
float per pixel, in the JAX package's order.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import rng as rng_mod


@dataclasses.dataclass
class Reservoir:
    """Per-pixel ReSTIR DI reservoirs over N pixels."""

    weight_sum: torch.Tensor    # (N,) sum of w
    M: torch.Tensor             # (N,) f32 confidence (sample count, m-capped)
    W: torch.Tensor             # (N,) unbiased contribution weight
    light_point: torch.Tensor   # (N,3) point on the light (direction if envmap)
    light_normal: torch.Tensor  # (N,3)
    radiance: torch.Tensor      # (N,3) emitted radiance of the sample
    target: torch.Tensor        # (N,) p_hat at this pixel's surface
    is_envmap: torch.Tensor     # (N,) bool: light_point is a direction

    # pack_columns' width: one row gather reads a whole reservoir
    N_COLS = 14

    @classmethod
    def empty(cls, n: int, device) -> "Reservoir":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            weight_sum=torch.zeros((n,), **f32),
            M=torch.zeros((n,), **f32),
            W=torch.zeros((n,), **f32),
            light_point=torch.zeros((n, 3), **f32),
            light_normal=torch.zeros((n, 3), **f32),
            radiance=torch.zeros((n, 3), **f32),
            target=torch.zeros((n,), **f32),
            is_envmap=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    def replace(self, **kw) -> "Reservoir":
        return dataclasses.replace(self, **kw)

    def _take(self, take, light_point, light_normal, radiance, target,
              is_envmap, **kw) -> "Reservoir":
        t3 = take[:, None]
        return Reservoir(
            light_point=torch.where(t3, light_point, self.light_point),
            light_normal=torch.where(t3, light_normal, self.light_normal),
            radiance=torch.where(t3, radiance, self.radiance),
            target=torch.where(take, target, self.target),
            is_envmap=torch.where(take, is_envmap, self.is_envmap),
            W=self.W, **kw)

    def update_tracked(self, rng_state, w, light_point, light_normal,
                       radiance, target, is_envmap, valid):
        """Stream one candidate into each reservoir (masked). Returns
        (reservoir, rng_state, take: did the candidate become the winner)."""
        w = torch.where(valid & torch.isfinite(w) & (w >= 0.0), w, 0.0)
        new_sum = self.weight_sum + w
        new_M = self.M + torch.where(valid, 1.0, 0.0)
        rng_state, u = rng_mod.next_float(rng_state)
        take = (u * new_sum < w) & (w > 0.0)
        res = self._take(take, light_point, light_normal, radiance, target,
                         is_envmap, weight_sum=new_sum, M=new_M)
        return res, rng_state, take

    def update(self, rng_state, w, light_point, light_normal, radiance,
               target, is_envmap, valid):
        """update_tracked without the winner flag."""
        res, rng_state, _ = self.update_tracked(
            rng_state, w, light_point, light_normal, radiance, target,
            is_envmap, valid)
        return res, rng_state

    def combine_tracked(self, rng_state, other: "Reservoir", target_here,
                        m_weight, valid):
        """Merge another reservoir's winning sample into this one
        (reference: Reservoir.h combine_with). ``target_here``: p_hat of
        other's sample at this pixel; ``m_weight``: its MIS or confidence
        weight. Returns (reservoir, rng_state, take)."""
        w = m_weight * target_here * other.W
        w = torch.where(valid & torch.isfinite(w) & (w > 0.0), w, 0.0)
        new_sum = self.weight_sum + w
        new_M = self.M + torch.where(valid, other.M, 0.0)
        rng_state, u = rng_mod.next_float(rng_state)
        take = (u * new_sum < w) & (w > 0.0)
        res = self._take(take, other.light_point, other.light_normal,
                         other.radiance, target_here, other.is_envmap,
                         weight_sum=new_sum, M=new_M)
        return res, rng_state, take

    def combine(self, rng_state, other: "Reservoir", target_here, m_weight,
                valid):
        """combine_tracked without the winner flag."""
        res, rng_state, _ = self.combine_tracked(
            rng_state, other, target_here, m_weight, valid)
        return res, rng_state

    def finalize(self, normalization=None) -> "Reservoir":
        """The UCW W = w_sum / (normalization * p_hat(y)) (reference:
        Reservoir.h end / end_with_normalization); the default
        normalization is M (the 1/M estimator)."""
        norm = self.M if normalization is None else normalization
        W = self.weight_sum / (norm * self.target).clamp_min(1e-12)
        W = torch.where((self.target > 0.0) & (norm > 0.0) & torch.isfinite(W),
                        W, 0.0)
        return self.replace(W=W)

    def m_capped(self, m_cap) -> "Reservoir":
        """Clamp the confidence at m_cap (0: no cap)."""
        if m_cap <= 0:
            return self
        return self.replace(M=self.M.clamp_max(float(m_cap)))

    def gather(self, idx) -> "Reservoir":
        """Reservoirs at pixel indices idx (neighbour taps)."""
        return Reservoir(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})

    def pack_columns(self) -> torch.Tensor:
        """(N, 14) f32: [weight_sum, M, W, light_point, light_normal,
        radiance, target, is_envmap]: a neighbour tap reads one row."""
        return torch.cat([
            self.weight_sum[:, None], self.M[:, None], self.W[:, None],
            self.light_point, self.light_normal, self.radiance,
            self.target[:, None], self.is_envmap.to(torch.float32)[:, None],
        ], dim=1)

    @classmethod
    def from_columns(cls, cols: torch.Tensor) -> "Reservoir":
        """Inverse of pack_columns (cols (N, 14))."""
        return cls(weight_sum=cols[:, 0], M=cols[:, 1], W=cols[:, 2],
                   light_point=cols[:, 3:6], light_normal=cols[:, 6:9],
                   radiance=cols[:, 9:12], target=cols[:, 12],
                   is_envmap=cols[:, 13] > 0.5)

    def sanity_mask(self) -> torch.Tensor:
        """NaN / negative guard (reference: Reservoir.h:108-162)."""
        return (torch.isfinite(self.weight_sum) & torch.isfinite(self.W)
                & (self.weight_sum >= 0.0) & (self.W >= 0.0)
                & torch.isfinite(self.radiance).all(dim=-1))
