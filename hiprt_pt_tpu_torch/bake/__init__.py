"""Baked lookup tables of the principled BSDF, byte-identical copies of the
JAX package's ``bake/data_*.npy`` (read by models/principled.py)."""
