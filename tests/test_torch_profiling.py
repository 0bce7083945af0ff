"""The port's utils/profiling against the JAX package's: a named region in
the written trace, and a NaN check that raises inside its context (forward
and backward) and not outside it."""

import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from burn_raymarching_tpu_torch.utils import profiling


def test_trace_holds_the_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("viewer_frame"):
            a = torch.randn(64, 64) @ torch.randn(64, 64)
    assert torch.isfinite(a).all()
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "prog.viewer_frame" in names


def test_trace_window_reads_a_host_only_trace(tmp_path):
    """tools/trace_window's reader on a CPU trace: no launches, so no kernel
    is lost; the margin is taken only with a card."""
    from burn_raymarching_tpu_torch.tools.trace_window import region_events

    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir, margin_s=60.0):
        torch.randn(16, 16).sum()
    got = region_events(os.path.join(logdir, "trace.json"))
    assert got == {"kernels": 0, "launches": 0, "lost": 0,
                   "first_kernel_minus_first_launch_us": None}


def test_annotate_outside_a_trace_is_transparent():
    with profiling.annotate("region"):
        out = torch.ones(3) * 2.0
    assert torch.equal(out, torch.full((3,), 2.0))


def test_debug_mode_raises_on_a_forward_nan():
    with pytest.raises(FloatingPointError, match="log"):
        with profiling.debug_mode():
            torch.log(torch.tensor(-1.0))


def test_debug_mode_raises_on_a_backward_nan():
    x = torch.tensor([0.0], requires_grad=True)
    with profiling.debug_mode():
        y = (torch.sqrt(x) * 0.0).sum()       # forward finite
        assert torch.isfinite(y)
        with pytest.raises(FloatingPointError):
            y.backward()                       # inf * 0 in sqrt's backward


def test_debug_mode_is_off_outside_its_context():
    with profiling.debug_mode():
        torch.empty(1024)                      # uninitialised: not checked
        assert torch.equal(torch.zeros(2) + 1.0, torch.ones(2))
    assert torch.isnan(torch.log(torch.tensor(-1.0)))
    x = torch.tensor([0.0], requires_grad=True)
    (torch.sqrt(x) * 0.0).sum().backward()
    assert torch.isnan(x.grad).all()


def test_jax_debug_nans_raises_on_the_same_input():
    """The JAX package's ``debug_mode`` sets ``jax_debug_nans``; it reads
    the flag's old value with ``jax.config.read``, which jax 0.9 refuses
    (AttributeError before the body runs), so the flag is set here through
    its own context manager."""
    with pytest.raises(FloatingPointError, match="log"):
        with jax.debug_nans(True):
            jnp.log(jnp.float32(-1.0)).block_until_ready()
    assert jnp.isnan(jnp.log(jnp.float32(-1.0)))
