"""Nothing the benchmark runs loads JAX or the JAX package, compared on
whole top-level module names; the reference loads nothing of the port."""

import os
import subprocess
import sys

from portbench.run import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax.linen": 1,
            "hiprt_pt_tpu": 1, "hiprt_pt_tpu.core.rng": 1,
            "hiprt_pt_tpu_torch": 1, "hiprt_pt_tpu_torch.ops": 1,
            "jaxtyping": 1, "portbench": 1}
    assert forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "hiprt_pt_tpu",
         "hiprt_pt_tpu.core.rng"])


def test_harness_reference_and_readers_load_no_jax():
    code = """
import glob, importlib, os, sys
import portbench.run, portbench.harness, portbench.check, portbench.ranks
import portbench.control, portbench.system, portbench.trace
from portbench.cell import load_cell, inputs
from portbench import system
from portbench.harness import metric_readers
metric_readers(os.path.basename(p)[:-3] for p in glob.glob('portbench/metrics/*.py'))
for m in ('render.renderer', 'render.integrator', 'restir.di', 'assets.gltf',
          'assets.envmap', 'assets.textures', 'accel', 'ops.traverse'):
    importlib.import_module('portbench.reference.' + m)
import hiprt_pt_tpu_torch.render.renderer, hiprt_pt_tpu_torch.parallel.launch
import hiprt_pt_tpu_torch.assets.loader
print(portbench.run.forbidden_modules())
"""
    assert _run(code) == "[]"


def test_reference_loads_nothing_of_the_port():
    code = """
import importlib, sys
for m in ('render.renderer', 'render.integrator', 'restir.di', 'lights.ris',
          'assets.gltf', 'assets.envmap', 'assets.textures', 'assets.scene',
          'accel', 'ops.traverse', 'ops.routing'):
    importlib.import_module('portbench.reference.' + m)
import portbench.check, portbench.inputs.stress, portbench.inputs.glb
import portbench.inputs.cornell, portbench.inputs.envmap
print(sorted(m for m in sys.modules if m.split('.')[0].startswith('hiprt_pt_tpu')))
"""
    assert _run(code) == "[]"
