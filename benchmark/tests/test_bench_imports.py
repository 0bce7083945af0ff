"""Nothing the benchmark runs loads JAX or the JAX package, compared by
top-level module name, whole; the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

from benchmark.harness import imports, manifest


def test_top_level_names_are_compared_whole():
    assert imports.forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert imports.forbidden_loaded(["jaxlib.xla_client"]) == ["jaxlib"]
    assert imports.forbidden_loaded(["flax.linen"]) == ["flax"]
    assert imports.forbidden_loaded(["burn_raymarching_tpu.ops"]) == [
        "burn_raymarching_tpu"]
    assert imports.forbidden_loaded([
        "burn_raymarching_tpu_torch", "burn_raymarching_tpu_torch.train",
        "jaxtyping", "benchmark.harness"]) == []


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub):
    base = os.path.join(manifest.BENCH_DIR, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    names = [n for p in _sources("") for n in _imported(p)]
    assert names
    assert imports.forbidden_loaded(names) == []


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        for n in _imported(p):
            assert n.split(".")[0] != "burn_raymarching_tpu_torch", p


def test_the_harness_and_the_program_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.harness.main, benchmark.harness.train, "
            "benchmark.harness.view; "
            "import burn_raymarching_tpu_torch.train.loop, "
            "burn_raymarching_tpu_torch.tools.viewer_server; "
            "from benchmark.harness.imports import forbidden_loaded; "
            "print(forbidden_loaded())" % manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip().splitlines()[-1] == "[]"
