"""The benchmark of the PyTorch and CUDA port (hiprt_pt_tpu_torch): one run
of one cell of BENCHMARK.json is ``python3 -m portbench.run``. See
portbench/README.md."""
