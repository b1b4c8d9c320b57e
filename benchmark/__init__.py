"""The benchmark of the PyTorch and CUDA port (``deepcam_tpu_torch``).

``run.py`` runs one cell once; ``BENCHMARK.json`` at the checkout's root
lists the cells, configurations and metrics, whose files this folder holds
(``configs/``, ``workloads/``, ``metrics/``), with the model families that
configurations name (``families/``).  The yardstick lives here too: the
traffic generator, the plain fp32 reference (``reference/``), the
frozen trace and roofline arithmetic (``frozen/``) and the comparison that
decides ``correct`` (``check.py``).  Nothing here imports JAX or the JAX
package, and the reference imports nothing of the program.
"""
