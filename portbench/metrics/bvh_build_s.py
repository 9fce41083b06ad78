"""Host set-up (accel/build.py): seconds to build the BVH and move its
tables to the card: for a scene file, load_scene_file's "bvh" stage; for
arrays, build_bvh timed from the harness to a device synchronise."""


def read(ctx):
    return ctx["setup"]["bvh_build_s"]
