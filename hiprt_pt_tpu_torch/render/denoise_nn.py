"""Learned denoiser — a small residual CNN over the same AOVs OIDN consumes,
mirroring ``hiprt_pt_tpu.render.denoise_nn`` (reference: the Intel OIDN
"RT" filter, src/Renderer/OpenImageDenoiser.cpp:114-140).

Architecture (the JAX package's, ~50k params):
  input  = [log1p(noisy), log1p(atrous), albedo, normal,
            log1p(rel-variance), log(spp)/8]           (14 channels)
  conv3x3(32) relu -> conv3x3(32) relu -> conv3x3(32, dilation 2) relu
  -> conv3x3(32, dilation 4) relu -> conv3x3(3)
  output = expm1( log1p(atrous) + delta )  clamped >= 0
The network is an ``nn.Module`` of five ``Conv2d`` layers (OIHW weights,
NCHW images; SAME padding at dilation d is padding d). The convolutions run
in f32: cuDNN's TF32 is switched off around them, whatever the caller's
global setting.

Weights ship at ``hiprt_pt_tpu_torch/bake/data_denoiser.npz``, a copy of the
JAX package's file (HWIO arrays ``w0..w4``, ``b0..b4``); ``save_params``
writes the same layout, so either package reads the other's file.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device

WEIGHTS_PATH = os.path.join(
    os.path.dirname(__file__), "..", "bake", "data_denoiser.npz"
)

_LAYERS = ((14, 32, 1), (32, 32, 1), (32, 32, 2), (32, 32, 4), (32, 3, 1))


class DenoiserNet(nn.Module):
    """The five 3x3 convolutions of _LAYERS, ReLU between them."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=d, dilation=d)
            for cin, cout, d in _LAYERS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs[:-1]:
            x = torch.relu(conv(x))
        return self.convs[-1](x)


def init_params(generator: torch.Generator, scale: float = 0.1,
                device=None) -> DenoiserNet:
    """He-ish init from ``generator``; final layer zero so the untrained net
    is the identity residual (output == à-trous input). The draws are
    torch's, not the JAX package's."""
    net = DenoiserNet()
    with torch.no_grad():
        for conv, (cin, cout, _d) in zip(net.convs, _LAYERS):
            w = torch.randn((cout, cin, 3, 3), generator=generator)
            conv.weight.copy_(w * (scale / np.sqrt(9 * cin)))
            conv.bias.zero_()
        net.convs[-1].weight.zero_()
    return net.to(resolve_device(device))


def apply(params: DenoiserNet, noisy, atrous, albedo, normal, variance=None,
          spp=None) -> torch.Tensor:
    """Denoise (H, W, 3) HDR images. variance: (H, W) luminance variance of
    the mean; spp: (H, W) per-pixel sample counts."""
    H, W, _ = noisy.shape
    dev = noisy.device
    if variance is None:
        variance = torch.zeros((H, W), dtype=torch.float32, device=dev)
    if spp is None:
        spp = torch.ones((H, W), dtype=torch.float32, device=dev)
    ln = torch.log1p(noisy.clamp_min(0.0))
    la = torch.log1p(atrous.clamp_min(0.0))
    rel_v = torch.log1p(variance / torch.clamp_min(
        noisy.clamp_min(0.0).mean(dim=-1) ** 2 + 1e-4, 1e-4))
    x = torch.cat(
        [ln, la, albedo, normal, rel_v[..., None],
         (torch.log2(spp.clamp_min(1.0)) / 8.0)[..., None]],
        dim=-1,
    ).permute(2, 0, 1)[None]
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        delta = params(x)[0].permute(1, 2, 0)
    return torch.clamp_min(torch.expm1(la + delta), 0.0)


# the JAX package's jitted entry; the port runs eagerly
apply_jit = apply


def load_params(path: Optional[str] = None,
                device=None) -> Optional[DenoiserNet]:
    """The weights at ``path`` (default: WEIGHTS_PATH, the shipped ones) on
    ``device`` (default: the GPU); None if the file is absent."""
    path = path or WEIGHTS_PATH
    if not os.path.exists(path):
        return None
    from ..interop import denoiser_params_from_numpy

    with np.load(path) as data:
        return denoiser_params_from_numpy(dict(data), device)


def save_params(params: DenoiserNet, path: Optional[str] = None):
    """Write ``params`` to ``path`` (default: WEIGHTS_PATH) as the JAX
    package does: HWIO ``w{i}``, ``b{i}``."""
    path = path or WEIGHTS_PATH
    ws = {f"w{i}": c.weight.detach().permute(2, 3, 1, 0).cpu().numpy()
          for i, c in enumerate(params.convs)}
    bs = {f"b{i}": c.bias.detach().cpu().numpy()
          for i, c in enumerate(params.convs)}
    np.savez(path, **ws, **bs)
