"""Screenshot helpers — auto-named captures of the current view, mirroring
``hiprt_pt_tpu.app.screenshot`` (reference: Screenshoter,
src/UI/Screenshoter.h:29-38: readback to PNG with an auto filename of
date, spp and resolution)."""

from __future__ import annotations

import datetime
import os


def auto_filename(scene_path: str, spp: int, width: int, height: int,
                  out_dir: str = ".") -> str:
    """<scene>_MM.DD.YYYY.HH.MM.SS_<spp>sp@<WxH>.png — same naming scheme as
    the reference's Screenshoter."""
    stem = os.path.splitext(os.path.basename(scene_path))[0]
    stamp = datetime.datetime.now().strftime("%m.%d.%Y.%H.%M.%S")
    return os.path.join(out_dir, f"{stem}_{stamp}_{spp}sp@{width}x{height}.png")


def screenshot(renderer, path: str | None = None, exposure: float = 1.0,
               gamma: float = 2.2, denoised: bool = False) -> str:
    """Capture the renderer's current display image to PNG."""
    import torch

    from ..assets.image_io import write_png

    if denoised:
        from ..ops.tonemap import tonemap_gamma
        from ..render.denoise import denoise

        img = tonemap_gamma(torch.from_numpy(denoise(renderer)), exposure,
                            gamma).numpy()
    else:
        img = renderer.ldr_image(exposure, gamma)
    path = path or auto_filename(
        "render", renderer.state.sample_count, renderer.width, renderer.height)
    write_png(path, img, gamma_encode=False)
    return path
