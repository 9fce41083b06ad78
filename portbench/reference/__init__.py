"""The plain reference that decides ``correct``: a frozen copy of the
render code in plain PyTorch (camera pass, integrator, the principled BSDF
and the other models, NEE, MIS and RIS, envmap sampling, the alpha-aware
shadow march, ReSTIR DI, textures, the glTF parse and the scene tables),
with a BVH and a walk of its own (accel.py, ops/traverse.py:walk) in place
of the program's builder and kernels. It imports nothing of the program:
it parses the same input files and builds every table again itself. Its
baked tables (bake/) are byte copies of the shipped LUTs.

In the program's place, under check.py:bf16_shading, it is the control:
each vertex's shading values and the ReSTIR reservoirs rounded to
bfloat16 (render/integrator.py:ROUND)."""
