"""Host set-up (assets/loader.py, assets/scene.py): seconds to load the
scene without its BVH: for a scene file, load_scene_file's total less its
"bvh" stage; for arrays, build_scene and the envmap's tables, timed from
the harness to a device synchronise."""


def read(ctx):
    return ctx["setup"]["scene_load_s"]
