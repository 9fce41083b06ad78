"""Several ranks (parallel/mesh.py): milliseconds a frame that a rank's
collectives take as a user's run makes them (collective_stats with
sync=False, host clock), averaged over the ranks and the traced frames."""


def read(ctx):
    return ctx.get("collective_ms")
