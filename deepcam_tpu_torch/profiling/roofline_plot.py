"""Roofline plot (counterpart of ``deepcam_tpu/profiling/roofline_plot.py``,
after the reference's ``analysis/roofline_plot.ipynb``): measured points,
``RooflineReport``s of ``profiler.roofline`` or ``cli/profile.py``'s
reports, against a card's memory and bf16 tensor-core roofs from
``profiler.GPU_PEAKS``.  matplotlib is imported inside the function.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional

import numpy as np

from .profiler import GPU_PEAKS, RooflineReport


def plot_roofline(points: Iterable[RooflineReport | Mapping], generation: str = "h100-sxm",
                  output_path: str = "roofline.png", title: Optional[str] = None) -> str:
    """Renders arithmetic intensity against TFLOP/s with the given points:
    RooflineReports, or dicts with ``arithmetic_intensity`` and
    ``achieved_tflops`` (and an optional ``label``).  Returns the path."""
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    peaks = GPU_PEAKS[generation]
    peak_tf, hbm_gbps = peaks["bf16_tflops"], peaks["hbm_gbps"]
    ai = np.logspace(-2, 4, 200)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.loglog(ai, np.minimum(ai * hbm_gbps / 1e3, peak_tf), "-", color="black", lw=2,
              label=f"HBM {hbm_gbps:.0f} GB/s / bf16 tensor cores {peak_tf:.0f} TF/s")
    ax.axvline(peak_tf * 1e3 / hbm_gbps, color="gray", ls=":", lw=1)
    for p in points:
        if isinstance(p, RooflineReport):
            x, y, label = p.arithmetic_intensity, p.achieved_tflops, p.device
        else:
            x, y, label = p["arithmetic_intensity"], p["achieved_tflops"], p.get("label", "")
        ax.plot([x], [y], "o", markersize=10, label=label or None)
    ax.set_xlabel("arithmetic intensity [FLOP/byte]")
    ax.set_ylabel("achieved [TFLOP/s]")
    ax.set_title(title or f"{generation} roofline")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(loc="lower right", fontsize=8)
    fig.savefig(output_path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return output_path
