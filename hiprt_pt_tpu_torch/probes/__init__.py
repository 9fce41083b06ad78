"""Measurement probes of the port: ``r5probe2`` (the round-5 gather probes
P1 and P2 as CUDA kernels, with their plain PyTorch versions)."""
