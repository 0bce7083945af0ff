"""backward_ms_per_step.dense: backward_ms_per_step.train's reading, in the dense training cell, which
reports its own end-to-end rate (train_rays_per_s.dense)."""

from benchmark.harness.manifest import metric_reader

read = metric_reader("backward_ms_per_step.train")
