"""device_idle_share.dense: device_idle_share.train's reading, in the dense training cell, which
reports its own end-to-end rate (train_rays_per_s.dense)."""

from benchmark.harness.manifest import metric_reader

read = metric_reader("device_idle_share.train")
