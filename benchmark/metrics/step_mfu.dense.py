"""step_mfu.dense: step_mfu.train's reading, in the dense training cell, which
reports its own end-to-end rate (train_rays_per_s.dense)."""

from benchmark.harness.manifest import metric_reader

read = metric_reader("step_mfu.train")
