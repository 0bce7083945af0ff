"""The roofline and *_mfu counts on small shapes, held to the kernel table
of PERF.md."""

import types

import pytest

from benchmark.harness import counts, devtrace, manifest

# One H100 SXM at its maximum clock: 16 SFU lanes x 132 SMs x 1.98 GHz.
PEAKS = {"sfu_per_s": 16 * 132 * 1.98e9, "fp32_per_s": 67e12,
         "bytes_per_s": 3.35e12}


def test_march_count_reproduces_the_kernel_table():
    # K1: 16,384 rays x 100 live slots, 40 steps: bound 0.0368 ms.
    k1 = counts.march(16384 * 100, 40)
    assert k1.least_s(PEAKS) * 1e3 == pytest.approx(0.0368, rel=2e-3)
    # K3 warm: 512 rays x 13,391 valid slots, 16 steps: 0.0754 ms.
    k3 = counts.march(512 * 13391, 16)
    assert k3.least_s(PEAKS) * 1e3 == pytest.approx(0.0754, rel=2e-3)


def test_repulsion_pairs_and_bound():
    # C = 80 clusters of 64, 8 near: 80 x 64 x (512 + 80) pairs.
    pairs = counts.cluster_repulsion_pairs(5120, 64, 8)
    assert pairs == 80 * 64 * (8 * 64 + 80)
    fwd = counts.repulsion_fwd(pairs)
    assert fwd.least_s(PEAKS) * 1e3 == pytest.approx(0.00145, rel=5e-3)
    assert counts.cluster_repulsion_pairs(100, 64, 8) == 2 * 64 * (
        2 * 64 + 2)


def test_least_time_is_the_largest_bound():
    w = counts.Work(sfu=0.0, fp32=67e12, nbytes=0.0)
    assert w.least_s(PEAKS) == pytest.approx(1.0)
    w = w + counts.Work(nbytes=2 * 3.35e12)
    assert w.least_s(PEAKS) == pytest.approx(2.0)
    assert (w * 2).least_s(PEAKS) == pytest.approx(4.0)


def _events(device, ranges):
    ev = devtrace.Events.__new__(devtrace.Events)
    ev.device = sorted(device)
    ev.ranges = sorted(ranges)
    ev.launches = [10.0, 20.0]
    ev.lo, ev.hi = 0.0, 1e6
    return ev


def _train_run(events, culled=False):
    return types.SimpleNamespace(
        events=events, slice_steps=100, culled=culled, batch=16384,
        tile=512, march_steps=40, slice_live=100 * 100.0,
        slice_valid=100 * 13391.0, slice_rep_pairs=0.0, peaks=PEAKS,
        march_pairs=lambda: 16384 * 100 * 100.0,
        step_work=lambda: counts.march(16384 * 100 * 100.0, 40))


def test_rooflines_and_mfu_from_a_trace():
    # 100 K1 launches of 0.0915 ms inside chunk ranges: 40% of the bound.
    k1 = [(1000.0 * i, 1000.0 * i + 91.5, "march_shade_kernel<4>")
          for i in range(100)]
    run = _train_run(_events(k1, [(0.0, 2e5, "chunk"), (0.0, 1e6,
                                                           "slice")]))
    share = manifest.metric_reader("k1_roofline.train")(run)
    assert share == pytest.approx(40.2, abs=0.3)
    mfu = manifest.metric_reader("step_mfu.train")(run)
    assert 0.0 < mfu < share
    # No K2 ran: its reader finds nothing and returns nothing.
    assert manifest.metric_reader("k2_roofline.train")(run) is None
    assert manifest.metric_reader("k3_roofline.train")(run) is None
    idle = manifest.metric_reader("device_idle_share.train")(run)
    assert idle == pytest.approx(100.0 * (1.0 - 9150.0 / 1e6))
    assert manifest.metric_reader("host_launches_per_step.train")(run) \
        == pytest.approx(0.02)


def test_torch_ops_leave_out_hand_kernels():
    dev = [(0.0, 10.0, "march_shade_kernel"), (10.0, 30.0, "elementwise"),
           (40.0, 50.0, "ncclKernel_AllReduce"), (500.0, 900.0, "outside")]
    run = _train_run(_events(dev, [(0.0, 100.0, "chunk")]))
    run.slice_steps = 1
    ms = manifest.metric_reader("torch_ops_ms_per_step.train")(run)
    assert ms == pytest.approx(0.020)


def test_union_counts_overlap_once():
    assert devtrace.union_us([(0, 10, "a"), (5, 15, "b"), (20, 25, "c")]) \
        == 20
