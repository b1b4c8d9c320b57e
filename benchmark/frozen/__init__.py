"""Frozen copies of the program's trace and roofline arithmetic.

The benchmark's yardstick must not move when the program changes, so the
pieces it reads traces and bounds with are copied here from the port at
commit 2718cf8 and are not imported from it: ``roofline.py`` from
``deepcam_tpu_torch/profiling/profiler.py:unit_counts`` and
``chip_smoke.py:bound``/``unit_bounds``; ``op_table.py`` from
``deepcam_tpu_torch/profiling/op_table.py`` (``kernel_family``,
``_Intervals``, ``load_device_ops``); ``module_scopes.py`` from
``deepcam_tpu_torch/profiling/profiler.py:ModuleScopes``.  Each file says
what it changed.
"""
