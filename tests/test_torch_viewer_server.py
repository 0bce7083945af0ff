"""The port's HTTP viewer (tools/viewer_server.py): the cases of
tests/test_viewer_server.py on the tracked config-4 headline scene (1,340
spheres), a frame's pixels against the JAX package's ``_ViewerState``, and
the standard-library PNG encoder the frames go through."""

import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from burn_raymarching_tpu.tools.viewer_server import (
    _ViewerState as JViewerState,
)
from burn_raymarching_tpu_torch.data.image_io import (
    encode_png_rgb,
    read_png,
    write_png_rgb,
)
from burn_raymarching_tpu_torch.tools.generate import dango_scene
from burn_raymarching_tpu_torch.tools.viewer_server import (
    _ViewerState,
    make_handler,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(ROOT, "runs", "c4_headline", "scene_c5.json")


def decode(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)))


@pytest.fixture
def serve():
    """Start a viewer on a free localhost port for a state → its base URL;
    every server is shut down when the test ends."""
    servers = []

    def start(state):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        servers.append((srv, thread))
        return f"http://127.0.0.1:{srv.server_port}"

    yield start
    for srv, thread in servers:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


@pytest.fixture
def server(serve):
    return serve(_ViewerState(SCENE, size=32, model="viewer", device="cpu"))


def test_index_page(server):
    html = urllib.request.urlopen(server + "/").read().decode()
    assert "viewer" in html and "ArrowLeft" in html


def test_frame_renders_as_the_jax_viewer_does(server):
    png = urllib.request.urlopen(
        server + "/frame?yaw=0.3&pitch=0.2&dist=2.5").read()
    img = decode(png).astype(np.int32)
    assert img.shape == (32, 32, 3)
    assert img.max() > 0  # scene visible
    want = decode(JViewerState(SCENE, 32, "viewer").render(
        0.3, 0.2, 2.5, (0.0, 0.0, 0.0))).astype(np.int32)
    diff = np.abs(img - want)
    assert diff.mean() < 0.05, diff.mean()
    assert (diff > 2).mean() < 0.002, (diff > 2).mean()


def test_frame_default_params(server):
    png = urllib.request.urlopen(server + "/frame").read()
    assert png[:4] == b"\x89PNG"


def test_scene_endpoint(server):
    data = json.loads(urllib.request.urlopen(server + "/scene").read())
    assert data["num_spheres"] == 1340


def test_404(server):
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(server + "/nope")


def test_progressive_low_quality_frames(serve, tmp_path):
    """q=low serves the quarter-resolution dragging preview; q=full (and
    no q) serve the full size. The 256² frame is rendered from a 3-sphere
    scene (the reference dango), which keeps the CPU render short."""
    c, col, r = dango_scene()
    path = tmp_path / "scene.json"
    path.write_text(json.dumps({
        "num_spheres": 3, "centers": c.reshape(-1).tolist(),
        "colors": col.reshape(-1).tolist(), "radii": r.reshape(-1).tolist(),
        "light_dir": [0.5, 1.0, -0.5], "ambient_intensity": [0.2]}))
    state = _ViewerState(str(path), size=256, model="viewer", device="cpu")
    assert state.low_size == 64
    base = serve(state)
    low = decode(urllib.request.urlopen(base + "/frame?yaw=0.3&q=low").read())
    full = decode(urllib.request.urlopen(
        base + "/frame?yaw=0.3&q=full").read())
    assert low.shape == (64, 64, 3)
    assert full.shape == (256, 256, 3)
    # Same scene content: the low frame is a coarse version of full.
    assert low.max() > 0 and full.max() > 0


def test_encode_png_rgb_is_write_png_rgb(tmp_path):
    """encode_png_rgb gives the bytes write_png_rgb writes; Pillow and the
    port's reader decode them to the same pixels."""
    pixels = np.random.default_rng(0).integers(0, 256, (7, 5, 3),
                                               dtype=np.uint8)
    path = str(tmp_path / "a.png")
    write_png_rgb(pixels, path)
    with open(path, "rb") as f:
        assert f.read() == encode_png_rgb(pixels)
    assert np.array_equal(decode(encode_png_rgb(pixels)), pixels)
    assert np.array_equal(read_png(path), pixels)
    with pytest.raises(ValueError):
        encode_png_rgb(pixels[:, :, :2])
