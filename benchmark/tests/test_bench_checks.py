"""The output checks at a size a test run holds, on the CPU: a sound run
is correct, and a run with its timed path broken underneath, or the
lower-precision control in the program's place, is not.

Each test skips the harness's look for a card and drives the rest of a
run (set-up, the checked steps, the window, the reference and the
comparison) through ``train.run`` / ``view.run`` on the CPU, where the
program runs its plain versions."""

import pytest
import torch

from benchmark.harness import checks, train, view
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEED = 2147483647


def _train(workload, tmp_path):
    cell = tiny.cell(workload)
    res = train.run(cell, SEED, 0.5, False, str(tmp_path), CPU)
    ok, found = checks.judge(res["numbers"], cell.limits)
    return ok, found


@pytest.mark.parametrize("workload", ["c1_dango.train", "c4_knot.train"])
def test_a_sound_training_run_is_correct(workload, tmp_path):
    ok, found = _train(workload, tmp_path)
    assert ok, found
    for exact in ("init_gap", "draw_gap", "density_count_gap",
                  "density_gap"):
        assert found[exact]["value"] == 0.0
    assert "loss_rel.s1" in found


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: Adam never steps."""
    from burn_raymarching_tpu_torch.train import chunk

    def one(self, idx):
        self.step += 1
        loss, _ = self.step_fn(
            self.params, self.generator, self.stage, self.step, self.mask,
            self.packed, self.fg_pool, self.n_fg, idx=idx,
            t_cache=self.t_cache, clusters=self.clusters,
            rep_static=self.rep_static)
        self.loss.copy_(loss)

    monkeypatch.setattr(chunk.ChunkRunner, "_one", one)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from burn_raymarching_tpu_torch.train import step_body

    inner = step_body.compute_loss

    def half(params, out, tgt, *args, **kwargs):
        n = out.shape[0] // 2
        return inner(params, out[:n], tgt[:n], *args, **kwargs)

    monkeypatch.setattr(step_body, "compute_loss", half)


def _altered_answer(monkeypatch):
    """The loss the step produces, altered where it is produced."""
    from burn_raymarching_tpu_torch.train import step_body

    inner = step_body.compute_loss
    monkeypatch.setattr(step_body, "compute_loss",
                        lambda *a, **kw: inner(*a, **kw) * 1.01)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer],
                         ids=["unchanged", "half-batch", "altered"])
@pytest.mark.parametrize("workload", ["c1_dango.train", "c4_knot.train"])
def test_a_broken_training_step_is_not_correct(workload, fault, tmp_path,
                                               monkeypatch):
    fault(monkeypatch)
    ok, found = _train(workload, tmp_path)
    assert not ok, found


def _density_drops_one(monkeypatch):
    """Density control's answer altered where it is produced: the last
    primitive it returns left out."""
    from burn_raymarching_tpu_torch.models.scene import SceneParams
    from burn_raymarching_tpu_torch.train import loop

    inner = loop.Trainer._density_control

    def density(self, *args, **kwargs):
        p = inner(self, *args, **kwargs)
        return SceneParams(*(x.detach()[:-1] for x in (p.centers, p.colors,
                                                        p.radii)),
                           p.light_dir.detach(), p.ambient.detach())

    monkeypatch.setattr(loop.Trainer, "_density_control", density)


def _merge_skipped(monkeypatch):
    """Density control without its merge."""
    from burn_raymarching_tpu_torch.train import density

    monkeypatch.setattr(density, "merge_redundant",
                        lambda c, col, r, cell, scores=None: (c, col, r, 0))


def _prefill_skipped(monkeypatch):
    """A boundary that leaves the warm start's cache as the stage before
    left it: only the first two stages a trainer runs (the checked steps'
    and the window's first) prefill it."""
    from burn_raymarching_tpu_torch.train import loop

    inner = loop.Trainer.prefill_t_cache

    def prefill(self, padded, mask, smooth_k):
        self._filled = getattr(self, "_filled", 0) + 1
        if self._filled <= 2:
            inner(self, padded, mask, smooth_k)

    monkeypatch.setattr(loop.Trainer, "prefill_t_cache", prefill)


@pytest.mark.parametrize("workload,fault", [
    ("c1_dango.train", _density_drops_one),
    ("c4_knot.train", _density_drops_one),
    ("c4_knot.train", _merge_skipped),
    ("c4_knot.train", _prefill_skipped)],
    ids=["c1-drops-one", "c4-drops-one", "c4-merge-skipped",
         "c4-prefill-skipped"])
def test_a_broken_stage_boundary_is_not_correct(workload, fault, tmp_path,
                                                monkeypatch):
    """The window's first boundary is checked: faults that leave the
    first stage's checked steps alone still fail."""
    fault(monkeypatch)
    ok, found = _train(workload, tmp_path)
    assert not ok, found
    assert found["loss_rel"]["value"] <= found["loss_rel"]["limit"]


@pytest.mark.parametrize("workload,kinds", [
    ("c1_dango.train", ["control", "half_batch"]),
    ("c4_knot.train", ["control", "half_batch", "skip_merge"])])
def test_the_training_control_and_faults_fail_the_limits(workload, kinds,
                                                         tmp_path):
    cell = tiny.cell(workload)
    out = train.readings(cell, SEED, str(tmp_path), CPU, kinds)
    for kind, numbers in out.items():
        assert "loss_rel.s1" in numbers, (kind, numbers)
        ok, found = checks.judge(numbers, cell.limits)
        assert not ok, (kind, found)


def test_a_sound_viewer_run_is_correct(tmp_path):
    cell = tiny.cell("c4_knot.view")
    res = view.run(cell, SEED, 0.5, False, str(tmp_path), CPU)
    ok, found = checks.judge(res["numbers"], cell.limits)
    assert ok, found
    assert res["attempted"] >= 2
    assert sorted(res["metrics"]) == [
        "frame_ms_p50.full", "frame_ms_p50.preview", "frame_ms_p95.full",
        "frame_ms_p95.preview"]


def test_an_altered_frame_is_not_correct(tmp_path, monkeypatch):
    from burn_raymarching_tpu_torch.tools import viewer_server
    from benchmark.reference.image_io import decode_png, encode_png_rgb

    inner = viewer_server._ViewerState.render

    def render(self, *args, **kwargs):
        return encode_png_rgb(view.alter(decode_png(inner(self, *args,
                                                          **kwargs))))

    monkeypatch.setattr(viewer_server._ViewerState, "render", render)
    cell = tiny.cell("c4_knot.view")
    res = view.run(cell, SEED, 0.5, False, str(tmp_path), CPU)
    ok, found = checks.judge(res["numbers"], cell.limits)
    assert not ok, found


def test_the_viewer_control_fails_the_limits(tmp_path):
    cell = tiny.cell("c4_knot.view")
    out = view.readings(cell, SEED, str(tmp_path), CPU, ["control",
                                                          "altered"])
    for kind, numbers in out.items():
        ok, found = checks.judge(numbers, cell.limits)
        assert not ok, (kind, found)
