"""The viewer's traffic: the page's own loop, with what the page does not
set taken from the traffic file's ``assumed`` ranges."""

import itertools
import math

from benchmark.harness import manifest, view


def _traffic():
    return manifest.read_json(manifest.traffic_path("view"))


def _frames(seed, n):
    return list(itertools.islice(view.gestures(seed, _traffic()), n))


def test_each_drag_turns_by_the_page_constant_then_pauses_on_full_frames():
    t = _traffic()
    pool = view.gesture_pool(t)
    a = t["assumed"]
    for events, d_yaw, d_pitch, fulls in pool:
        assert a["drag_events"][0] <= events <= a["drag_events"][1]
        length = math.hypot(d_yaw, d_pitch) * events / t["drag_rad_per_px"]
        assert a["drag_px"][0] - 1e-6 <= length <= a["drag_px"][1] + 1e-6
        assert a["pause_full_frames"][0] <= fulls <= a["pause_full_frames"][1]
    frames = _frames(7, 2000)
    assert frames[0][2] == "low"
    assert all(abs(p) <= t["pitch_limit"] for _, p, _ in frames)
    # A full frame repeats the pose of the preview before it.
    for prev, cur in zip(frames, frames[1:]):
        if cur[2] == "full":
            assert cur[:2] == prev[:2]


def test_a_seed_plays_the_same_drags_in_its_own_order():
    t = _traffic()
    per_pool = sum(e + f for e, _, _, f in view.gesture_pool(t))
    a, b = _frames(1, per_pool), _frames(2, per_pool)
    assert a == _frames(1, per_pool)
    assert a != b
    count = lambda fs, q: sum(1 for f in fs if f[2] == q)
    assert count(a, "low") == count(b, "low")
    assert count(a, "full") == count(b, "full")
