"""The window's arithmetic: the rate is all the work over all the time,
the tail is the 95th percentile over every frame."""

import statistics

from portbench import yardstick


def test_rate_is_all_work_over_all_time():
    m = yardstick.window_metrics(frames=30, samples_per_frame=2, seconds=40.0,
                                 intervals_ms=[1000.0] * 30)
    assert m["spp_per_s"] == 30 * 2 / 40.0


def test_p95_is_over_every_frame_and_a_stall_moves_it():
    steady = [1000.0 + i for i in range(30)]
    # one frame stalls; at 30 frames the 95th percentile reads between the
    # second and third largest frames, so the stall lifts the others' rank
    stalled = [5000.0] + steady[1:]
    a = yardstick.window_metrics(30, 1, 30.0, steady)["frame_ms_p95"]
    b = yardstick.window_metrics(30, 1, 30.0, stalled)["frame_ms_p95"]
    assert b > a
    assert a == statistics.quantiles(steady, n=20, method="inclusive")[18]
    # not a median of chunks: the stall shows in the tail of all frames
    chunks = [statistics.median(stalled[i:i + 10]) for i in range(0, 30, 10)]
    assert b > max(chunks)


def test_least_seconds_takes_the_larger_bound():
    ops_bound = yardstick.least_seconds(10**9, 0, 1, 1, 0)
    assert ops_bound == 10**9 * yardstick.SLAB_OPS / yardstick.F32_OPS_PER_S
    byte_bound = yardstick.least_seconds(0, 0, 10**9, 0, 10**6)
    assert byte_bound == 10**9 * yardstick.RAY_BYTES / yardstick.BYTES_PER_S
