"""Data-side ports: the stdlib PNG codec, scene/camera JSON, fg indices,
batch sampling, density control (bit-identical) and the generator."""

import json
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from torch_parity import jax_params, nn, random_raw_params

from burn_raymarching_tpu.data import image_io as j_io
from burn_raymarching_tpu.data.dataset import compute_fg_indices as j_fg
from burn_raymarching_tpu.data.scene_io import export_scene_json as j_export
from burn_raymarching_tpu.train.density import prune_and_split as j_prune
from burn_raymarching_tpu_torch.config import DensityConfig
from burn_raymarching_tpu_torch.data import image_io
from burn_raymarching_tpu_torch.data.dataset import (
    compute_fg_indices,
    sample_batch_indices,
)
from burn_raymarching_tpu_torch.data.scene_io import export_scene_json
from burn_raymarching_tpu_torch.models.scene import params_from_numpy
from burn_raymarching_tpu_torch.train.density import prune_and_split


def _random_linear(seed, h, w):
    return np.random.default_rng(seed).uniform(0, 1, (h * w, 3)).astype(
        np.float32)


def test_reads_pillow_pngs_byte_for_byte(tmp_path):
    path = str(tmp_path / "jax.png")
    j_io.save_array_as_image(_random_linear(0, 13, 17), 17, 13, path)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(image_io.read_png(path), want)
    np.testing.assert_array_equal(image_io.load_image_as_array(path),
                                  j_io.load_image_as_array(path))
    assert image_io.image_size(path) == (17, 13)


def test_writer_matches_pillow_pipeline(tmp_path):
    img = _random_linear(1, 9, 11)
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    image_io.save_array_as_image(img, 11, 9, ours)
    j_io.save_array_as_image(img, 11, 9, theirs)
    np.testing.assert_array_equal(np.asarray(Image.open(ours)),
                                  np.asarray(Image.open(theirs)))


def _filter_row(ftype, row, prior, bpp):
    """PNG forward filter (spec section 9) for one row of bytes."""
    row, prior = row.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(row)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prior
    elif ftype == 3:
        pred = (left + prior) >> 1
    else:
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prior, upleft))
    return ((row - pred) % 256).astype(np.uint8)


@pytest.mark.parametrize("ctype,channels", [(2, 3), (6, 4)])
def test_reader_undoes_all_five_filters(tmp_path, ctype, channels):
    rng = np.random.default_rng(2)
    h, w = 10, 7
    px = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    rows = px.reshape(h, w * channels)
    raw = b""
    prior = np.zeros(w * channels, np.uint8)
    for y in range(h):
        ftype = y % 5
        raw += bytes([ftype]) + _filter_row(ftype, rows[y], prior,
                                            channels).tobytes()
        prior = rows[y]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    got = image_io.read_png(path)
    np.testing.assert_array_equal(got, px[:, :, :3])
    np.testing.assert_array_equal(got, np.asarray(
        Image.open(path).convert("RGB")))


def test_scene_json_matches_jax_export(tmp_path):
    raw = random_raw_params(4, 6)
    mask = np.arange(6) < 4
    want = j_export(jax_params(raw), str(tmp_path / "j.json"), mask=mask)
    got = export_scene_json(params_from_numpy(raw, device="cpu"),
                            str(tmp_path / "t.json"), mask=mask)
    with open(tmp_path / "t.json") as f:
        on_disk = json.load(f)
    assert set(got) == set(want) == set(on_disk)
    assert got["num_spheres"] == want["num_spheres"] == 4
    for key in want:
        if key != "num_spheres":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)


def test_fg_indices_exact():
    tgt = np.random.default_rng(5).uniform(0, 0.05, (500, 3))
    a, n_a = compute_fg_indices(tgt, 0.05)
    b, n_b = j_fg(tgt, 0.05)
    assert n_a == n_b > 0
    np.testing.assert_array_equal(a, b)


def test_sample_batch_indices_pools():
    fg = torch.tensor([3, 7, 11, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    idx = sample_batch_indices(gen, 10, fg, 3, 64, 0.25)
    assert idx.shape == (64,) and idx.dtype == torch.int64
    n_uniform = 64 - 3          # fg boost capped at |fg| = 3
    assert bool((idx[:n_uniform] < 10).all())
    assert set(idx[n_uniform:].tolist()) <= {3, 7, 11}
    idx2 = sample_batch_indices(torch.Generator().manual_seed(0), 10, fg, 3,
                                64, 0.25)
    assert torch.equal(idx, idx2)


@pytest.mark.parametrize("stage,merge_cell", [(0, 0.0), (1, 0.0), (4, 0.0),
                                              (0, 0.3)])
def test_prune_and_split_bit_identical(stage, merge_cell):
    rng = np.random.default_rng(6)
    m = 24
    c = rng.normal(0, 0.5, (m, 3)).astype(np.float32)
    col = rng.normal(0, 2, (m, 3)).astype(np.float32)
    r = rng.normal(-0.5, 1.0, (m, 1)).astype(np.float32)
    init = (c + rng.normal(0, 0.1, (m, 3))).astype(np.float32)
    cfg = DensityConfig(merge_cell=merge_cell)
    a = prune_and_split(c, col, r, init, stage, 5, np.random.default_rng(9),
                        cfg)
    b = j_prune(c, col, r, init, stage, 5, np.random.default_rng(9), cfg)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    assert vars(a[3]) == vars(b[3])
    if stage == 0:
        assert a[3].split > 0


def test_generator_matches_jax_generator(tmp_path, monkeypatch):
    from burn_raymarching_tpu.tools import generate as j_gen
    from burn_raymarching_tpu_torch.tools import generate as t_gen

    monkeypatch.chdir(tmp_path)
    j_gen.main(["--out", "j", "--size", "24"])
    t_gen.main(["--out", "t", "--size", "24", "--device", "cpu"])
    with open("j/cameras.json") as f:
        cams_j = json.load(f)
    with open("t/cameras.json") as f:
        cams_t = json.load(f)
    assert len(cams_t) == 10
    for cj, ct in zip(cams_j, cams_t):
        assert ct["file"] == cj["file"].replace("j/", "t/", 1)
        assert ct["origin"] == cj["origin"] and ct["fov"] == cj["fov"]
        a = image_io.read_png(ct["file"]).astype(int)
        b = np.asarray(Image.open(cj["file"])).astype(int)
        assert np.abs(a - b).max() <= 1          # within one 8-bit level
        assert (a != b).mean() < 0.01


def test_dataset_packs_rows_on_device():
    from burn_raymarching_tpu_torch.data.dataset import RayDataset

    rng = np.random.default_rng(7)
    ro, rd = rng.normal(size=(50, 3)), rng.normal(size=(50, 3))
    tgt = rng.uniform(0, 0.1, (50, 3))
    ds = RayDataset(ro, rd, tgt, fg_threshold=0.15, device="cpu")
    assert ds.packed.shape == (50, 9) and ds.packed.dtype == torch.float32
    gen = torch.Generator().manual_seed(1)
    o, d, t = ds.sample_batch(gen, 16, 0.5)
    assert o.is_contiguous() and t.shape == (16, 3)
    assert ds.num_fg + ds.num_bg == 50
    np.testing.assert_array_equal(nn(ds.targets), tgt.astype(np.float32))
