"""``train_step.mfu_pct`` in the loop cells, which carry no end-to-end rate (see
``samples_per_s_per_gpu.loop``): the same reader, under a name of its own."""

from benchmark import spec

read = spec.metric_module("train_step.mfu_pct").read
