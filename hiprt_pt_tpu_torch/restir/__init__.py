"""ReSTIR DI: reservoirs (reservoir.py), the reuse pipeline (di.py) and the
bias-status explainer (bias.py), mirroring ``hiprt_pt_tpu.restir``."""
