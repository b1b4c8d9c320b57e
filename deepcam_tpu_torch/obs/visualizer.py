"""Prediction-vs-label plots (counterpart of
``deepcam_tpu/obs/visualizer.py``, ``CamVisualizer``).

Channel 0 of a sample on a global lat/lon grid, with the contours of the
tropical-cyclone (class 1, orange) and atmospheric-river (class 2, magenta)
masks of the prediction (top) and of the label (bottom), titled from the
``data-YYYY-MM-DD-H-S.h5`` filename.  Pure matplotlib (equirectangular
axes) in place of the reference's Basemap; the colormap, the 180° longitude
roll and the contours are the reference's.  matplotlib is imported inside
the methods, so the module imports where it is missing.
"""

from __future__ import annotations

import os

import numpy as np


def _build_cmap():
    """The reference's 64-color LinearSegmentedColormap."""
    import matplotlib as mpl

    colors_1 = [(252 - 32 * i, 252 - 32 * i, 252 - 32 * i, i * 1 / 16)
                for i in np.linspace(0, 1, 32)]
    colors_2 = [(220 - 60 * i, 220 - 60 * i, 220, i * 1 / 16 + 1 / 16)
                for i in np.linspace(0, 1, 32)]
    colors_3 = [(160 - 20 * i, 160 + 30 * i, 220, i * 3 / 8 + 1 / 8)
                for i in np.linspace(0, 1, 96)]
    colors_4 = [(140 + 80 * i, 190 + 60 * i, 220 + 30 * i, i * 4 / 8 + 4 / 8)
                for i in np.linspace(0, 1, 96)]
    colors = [(c[0] / 256, c[1] / 256, c[2] / 256, c[3])
              for c in colors_1 + colors_2 + colors_3 + colors_4]
    return mpl.colors.LinearSegmentedColormap.from_list("mycmap", colors, N=64)


def parse_cam_filename(path: str):
    """``data-YYYY-MM-DD-H-S.h5`` → (year, month, day, hour, stream); zeros
    when the name does not parse."""
    token = os.path.basename(path).replace(".h5", "").split("-")
    try:
        return tuple(int(t) for t in token[1:6]) if len(token) >= 6 else (0,) * 5
    except ValueError:
        return (0,) * 5


class CamVisualizer:
    def __init__(self):
        import matplotlib

        matplotlib.use("agg")
        self.cmap = _build_cmap()

    def plot(self, input_filename, output_filename, data, prediction, label):
        """data, prediction, label: (H, W) numpy arrays (channel 0, argmax,
        ground truth).  Writes a PNG to ``output_filename``."""
        import matplotlib.pyplot as plt

        year, month, day, hour, stream = parse_cam_filename(input_filename)
        w = data.shape[-1]
        data, prediction, label = (np.roll(a, w // 2, axis=-1)
                                   for a in (data, prediction, label))
        xx, yy = np.meshgrid(np.linspace(-180, 180, w), np.linspace(-90, 90, data.shape[0]))

        fig, axvec = plt.subplots(figsize=(24, 10), nrows=2, ncols=1)
        for idx, ax in enumerate(axvec):
            ax.contourf(xx, yy, data, levels=np.arange(0.0, 1.0, 0.02), vmin=0.0, vmax=1.0,
                        cmap=self.cmap)
            mask = prediction if idx == 0 else label
            for cls, color in ((1, "orange"), (2, "magenta")):
                ax.contour(xx, yy, (mask == cls).astype(np.float32), [0.5], linewidths=3,
                           colors=color, alpha=0.9)
            ax.set_xticks(np.arange(-180, 181, 60))
            ax.set_yticks(np.arange(-90, 91, 30))
            ax.set_ylabel("prediction" if idx == 0 else "label")
            if idx == 0:
                ax.set_title("Extreme Weather Patterns {:04d}-{:02d}-{:02d} "
                             "(stream {:02d})".format(year, month, day, stream),
                             fontdict={"fontsize": 18})
        fig.savefig(output_filename, format="png", bbox_inches="tight")
        plt.close(fig)
