"""prefill_share.wide: prefill_share.train's reading, in the config-5 training cell
(c5_wide.train), which reports train_rays_per_s as c4_knot.train does."""

from benchmark.harness.manifest import metric_reader

read = metric_reader("prefill_share.train")
