"""The ``view`` traffic kind: one user of the HTTP viewer looking around a
trained scene, as the viewer's page (``tools/viewer_server._PAGE``) asks
for frames, in a closed loop with no think time (the viewer renders one
frame at a time under a lock, and the page keeps one in flight).

While the user drags, every pointermove event turns the orbit by the
page's 0.006 rad a pixel (pitch held within the page's ±1.4 rad) and asks
for a preview (the viewer's ``low_size``); on pointerup, and again every
300 ms without input, the page asks for a full frame (``size``). How long
a drag is, how far it goes and how long the user pauses after it are not
set by the page: the traffic file states them under ``assumed``. The
gestures come from a fixed pool that each seed plays in its own order, and
the pose carries on from gesture to gesture from the page's starting yaw
and pitch, at its distance. A frame is timed from the call into
``_ViewerState.render`` (the served path without the socket) to its PNG
bytes; previews and full frames are reported apart, each percentile over
every frame of its kind in the window. After the window a sample of the
served frames, drawn from the seed and holding the slowest full frame, is
compared with the reference's frames of the same poses.
"""

from __future__ import annotations

import gc
import json
import math
import os
import time

import numpy as np
import torch

from benchmark.harness import checks, counts, devtrace, stats
from benchmark.harness.manifest import ROOT
from benchmark.reference.camera import create_camera_rays
from benchmark.reference.diff import render_diff
from benchmark.reference.image_io import decode_png

VIEW_K = 32.0
FOV = 50.0
CHUNK = 16384


def gesture_pool(traffic: dict) -> list:
    """The traffic's fixed pool of gestures: (pointermove events, yaw and
    pitch turned by each, full frames of the pause after the drag), drawn
    from the ranges under ``assumed``; the drag's direction is uniform."""
    a = traffic["assumed"]
    rng = np.random.default_rng(0x71E3)
    rad = traffic["drag_rad_per_px"]
    pool = []
    for _ in range(traffic["gesture_pool"]):
        events = int(rng.integers(a["drag_events"][0],
                                  a["drag_events"][1] + 1))
        length = float(rng.uniform(*a["drag_px"]))
        angle = float(rng.uniform(0.0, 2.0 * math.pi))
        fulls = int(rng.integers(a["pause_full_frames"][0],
                                 a["pause_full_frames"][1] + 1))
        per = rad * length / events
        pool.append((events, per * math.cos(angle), per * math.sin(angle),
                     fulls))
    return pool


def gestures(seed: int, traffic: dict):
    """Endless (yaw, pitch, quality) frames: the gestures of
    ``gesture_pool`` played again and again, each time in an order drawn
    from the seed, so that every seed serves the same drags in another
    order; the pose carries on from the page's start."""
    pool = gesture_pool(traffic)
    order_rng = np.random.default_rng([seed, 0x71E3])
    yaw, pitch = traffic["start_yaw"], traffic["start_pitch"]
    lim = traffic["pitch_limit"]
    while True:
        for g in order_rng.permutation(len(pool)):
            events, d_yaw, d_pitch, fulls = pool[g]
            for _ in range(events):
                yaw += d_yaw
                pitch = min(lim, max(-lim, pitch + d_pitch))
                yield yaw, pitch, "low"
            for _ in range(fulls):
                yield yaw, pitch, "full"


def eye_of(yaw: float, pitch: float, dist: float, center) -> list:
    """The viewer's orbit camera (tools/viewer_server._ViewerState)."""
    cx, cy, cz = center
    return [cx + dist * math.cos(pitch) * math.sin(yaw),
            cy + dist * math.sin(pitch),
            cz - dist * math.cos(pitch) * math.cos(yaw)]


def load_scene(path: str, device, dtype=torch.float32) -> tuple:
    with open(path) as f:
        d = json.load(f)
    n = d["num_spheres"]
    shapes = {"centers": (n, 3), "colors": (n, 3), "radii": (n, 1),
              "light_dir": (3,), "ambient_intensity": (1,)}
    return tuple(torch.as_tensor(np.asarray(d[k], np.float32).reshape(s),
                                 device=device).to(dtype)
                 for k, s in shapes.items())


@torch.no_grad()
def reference_frame(scene: tuple, yaw: float, pitch: float, dist: float,
                    size: int, device) -> np.ndarray:
    """The frame the viewer's training model serves, by the plain march
    and renderer → [size, size, 3] uint8."""
    center = (0.0, 0.0, 0.0)
    ro, rd = create_camera_rays(size, size, eye_of(yaw, pitch, dist, center),
                                list(center), FOV, device=device)
    dtype = scene[0].dtype
    ro, rd = ro.to(dtype), rd.to(dtype)
    img = torch.cat([render_diff(ro[i:i + CHUNK], rd[i:i + CHUNK], *scene,
                                 VIEW_K)
                     for i in range(0, ro.shape[0], CHUNK)])
    img = img.float().cpu().numpy()
    u8 = (np.clip(img, 0, 1) ** (1 / 2.2) * 255).astype(np.uint8)
    return u8.reshape(size, size, 3)


def check_sample(seed: int, frames: list, traffic: dict) -> list[int]:
    """Indices of the frames to check: the slowest full frame, and more
    full and preview frames drawn from the seed."""
    rng = np.random.default_rng([seed, 0xC4EC])
    full = [i for i, f in enumerate(frames) if f["quality"] == "full"]
    low = [i for i, f in enumerate(frames) if f["quality"] == "low"]
    pick = []
    if full:
        slowest = max(full, key=lambda i: frames[i]["ms"])
        rest = [i for i in full if i != slowest]
        pick = [slowest] + [int(i) for i in rng.choice(
            rest, size=min(len(rest), traffic["check_full"] - 1),
            replace=False)]
    pick += [int(i) for i in rng.choice(
        low, size=min(len(low), traffic["check_low"]), replace=False)]
    return sorted(pick)


def run(cell, seed: int, seconds: float, traced: bool, tmp: str,
        device, note=lambda what: None) -> dict:
    """One run of the viewer cell → the harness's result fields."""
    from burn_raymarching_tpu_torch.tools.viewer_server import _ViewerState

    note("program imported")
    traffic = cell.traffic
    dist = traffic["distance"]
    scene_path = os.path.join(ROOT, cell.config["viewer"]["scene"])
    state = _ViewerState(scene_path, traffic["size"], traffic["model"],
                         device=str(device))
    sizes = {"low": state.low_size, "full": state.size}
    for quality in ("low", "full"):
        state.render(0.0, 0.2, dist, (0.0, 0.0, 0.0), quality)
    note("viewer warmed")
    spans = devtrace.Spans(traced)
    sl = devtrace.Slice() if traced else None
    slice_state, slice_frames = "before", []
    frames = []
    served = {"low": 0, "full": 0}
    t0 = time.perf_counter()
    setup_wall = time.time()
    for yaw, pitch, quality in gestures(seed, traffic):
        a = time.perf_counter()
        with spans.span("frame"):
            png = state.render(yaw, pitch, dist, (0.0, 0.0, 0.0), quality)
        b = time.perf_counter()
        frames.append({"yaw": yaw, "pitch": pitch, "quality": quality,
                       "ms": 1000.0 * (b - a), "png": png})
        if slice_state == "on":
            slice_frames.append(sizes[quality])
            if len(slice_frames) >= traffic["trace_frames"]:
                sl.stop()
                slice_state = "done"
        elif traced and slice_state == "before" and (
                len(frames) >= traffic["trace_from_frame"]):
            sl.start()
            slice_state = "on"
        served[quality] += 1
        if b >= t0 + seconds and min(served.values()) > 0:
            break
    if slice_state == "on":
        sl.stop()
        slice_state = "done"
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    metrics = {}
    for quality, kind in (("low", "preview"), ("full", "full")):
        ms = [f["ms"] for f in frames if f["quality"] == quality]
        for q in (50, 95):
            metrics[f"frame_ms_p{q}.{kind}"] = stats.percentile(ms, q)
    result = {"attempted": len(frames), "failed": 0,
              "setup_wall": setup_wall, "memory_peak_bytes": peak,
              "metrics": metrics}
    n_live = int(state.scene["num_spheres"])
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    seg = [stats.percentile([f["ms"] for f in frames[i:i + 500]], 50)
           for i in range(0, len(frames) - 499, 500)]
    note(f"window closed: {served['low']} previews, {served['full']} full "
         f"frames, median ms of each 500 frames: "
         f"{[round(x, 3) for x in seg]}")
    pick = check_sample(seed, frames, traffic)
    scene = load_scene(scene_path, device)
    served = [decode_png(frames[i]["png"]) for i in pick]
    ref = [reference_frame(scene, frames[i]["yaw"], frames[i]["pitch"],
                           dist, sizes[frames[i]["quality"]], device)
           for i in pick]
    result["numbers"] = checks.compare_frames(served, ref)
    note("reference run")
    if traced:
        result["trace"] = TraceRun(sl.events if slice_state == "done"
                                   else None, slice_frames, n_live)
    return result


class TraceRun:
    """What a per-layer reader of a viewer cell reads."""

    def __init__(self, events, slice_sizes: list, n_live: int):
        self.events = events
        self.slice_rays = float(sum(s * s for s in slice_sizes))
        self.n_live = n_live
        self.peaks = counts.card_peaks() if events is not None else None

    def march_work(self) -> counts.Work:
        return counts.march(self.slice_rays * self.n_live, 40)

    def frame_work(self) -> counts.Work:
        return self.march_work() + counts.shade_fwd(
            self.slice_rays * self.n_live)


def readings(cell, seed: int, tmp: str, device, kinds: list) -> dict:
    """The control's and the planted fault's numbers on ``seed``, over the
    frames of the seed's first gestures: the reference in bfloat16
    ("control"), and the reference's frames with one 16 × 16 block of each
    altered ("altered"), against the reference."""
    traffic = cell.traffic
    scene_path = os.path.join(ROOT, cell.config["viewer"]["scene"])
    sizes = {"low": max(64, traffic["size"] // 4), "full": traffic["size"]}
    gen = gestures(seed, traffic)
    full, low = [], []
    while len(full) < traffic["check_full"] or len(low) < traffic[
            "check_low"]:
        pose = next(gen)
        (full if pose[2] == "full" else low).append(pose)
    frames = full[:traffic["check_full"]] + low[:traffic["check_low"]]
    scene = load_scene(scene_path, device)
    ref = [reference_frame(scene, y, p, traffic["distance"], sizes[q],
                           device) for y, p, q in frames]
    out = {}
    for kind in kinds:
        if kind == "control":
            low = load_scene(scene_path, device, torch.bfloat16)
            other = [reference_frame(low, y, p, traffic["distance"],
                                     sizes[q], device) for y, p, q in frames]
        elif kind == "altered":
            other = [alter(f) for f in ref]
        else:
            raise ValueError(f"no reading {kind!r} for a viewer cell")
        out[kind] = checks.compare_frames(other, ref)
    return out


def alter(frame: np.ndarray) -> np.ndarray:
    """The frame with a 16 × 16 block at its center inverted."""
    out = frame.copy()
    h, w = out.shape[:2]
    y, x = h // 2 - 8, w // 2 - 8
    out[y:y + 16, x:x + 16] = 255 - out[y:y + 16, x:x + 16]
    return out
