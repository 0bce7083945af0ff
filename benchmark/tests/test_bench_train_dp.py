"""The ``train_dp`` kind on four gloo ranks on the CPU, at the size of
``dp_tiny.py``: the ranks stop at the same chunk end, a sound run keeps
the replicas equal and its exact numbers at 0, and a run with the mean
over the data axis left out, or half of each rank's batch, is not
correct.

On the CPU the program runs its plain float32 versions, and on this cut
the first stage's ambient gradient is small enough that float32 moves it
off float64 (the reference in float32 reads the program's numbers): the
sound run's first-stage ``delta_gap`` is not held to its limit here, and
a fault has to fail on a number that the sound run holds."""

import pytest
import torch

from benchmark.harness import checks, train_dp
from benchmark.tests import dp_tiny

CPU = torch.device("cpu")
SEED = 2147483647
CHUNK = 100           # DistributedTrainer's chunk at 100 steps a stage
HELD = ("loss_rel", "grad_gap", "loss_rel.s1", "grad_gap.s1",
        "delta_gap.s1", "init_gap", "draw_gap", "density_count_gap",
        "density_gap", "replica_gap")


@pytest.fixture(autouse=True)
def one_thread():
    """Rank 0 runs here: one thread, as each other rank (the four share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(tmp_path, plant=""):
    cell = dp_tiny.cell()
    res = train_dp.run(cell, SEED, 0.5, False, str(tmp_path), CPU,
                       plant=plant)
    return res, checks.judge(res["numbers"], cell.limits)[1]


def test_the_ranks_stop_together_and_stay_equal(tmp_path):
    res, found = _run(tmp_path)
    # run() raises where a rank stopped at another step.
    assert res["attempted"] >= 2 * CHUNK and res["attempted"] % CHUNK == 0
    for name in ("init_gap", "draw_gap", "density_count_gap", "density_gap",
                 "replica_gap"):
        assert found[name]["value"] == 0.0, name
    for name in HELD:
        assert found[name]["value"] <= found[name]["limit"], found


@pytest.mark.parametrize("fault", ["skip_mean", "half_batch"])
def test_a_planted_fault_is_not_correct(fault, tmp_path, monkeypatch):
    getattr(dp_tiny, fault)(monkeypatch.setattr)
    _, found = _run(tmp_path, plant=f"benchmark.tests.dp_tiny:{fault}")
    over = [n for n in HELD if found[n]["value"] is None
            or found[n]["value"] > found[n]["limit"]]
    assert over, found
