"""The application shell, mirroring ``hiprt_pt_tpu.app``: the command-line
renderer (``python -m hiprt_pt_tpu_torch.app.cli``), the browser viewer
(``ViewerServer``) and auto-named screenshots."""

from .screenshot import auto_filename, screenshot
from .viewer import ViewerServer

__all__ = ["cli_main", "auto_filename", "screenshot", "ViewerServer"]


def __getattr__(name):
    # imported on first use, so that ``python -m hiprt_pt_tpu_torch.app.cli``
    # does not find the module already imported by its package
    if name == "cli_main":
        from .cli import main

        return main
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
