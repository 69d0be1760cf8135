"""Figure helpers: the feature-map grid dumper (copy of
``fpn_mt_image_captioning_tpu/utils/figures.py``, which is framework-free).

``save_fig_png`` takes an NHWC activation batch, plots every channel of the
first example in a square grid with min/max titles, and writes
``<out_dir>/<filename>.png``. matplotlib is imported inside the function.
"""

from __future__ import annotations

import math
import os

import numpy as np

__all__ = ["save_fig_png"]


def save_fig_png(input_arr, filename: str, out_dir: str = "layers_figure") -> str:
    # an explicit Figure on an Agg canvas: writing a file needs no pyplot
    # state, and matplotlib.use("Agg") would switch the process-wide backend
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    arr = np.asarray(input_arr)[0]          # first batch element
    arr = np.transpose(arr, (2, 0, 1))       # channels first
    n = len(arr)
    side = math.ceil(n ** 0.5)

    fig = Figure(figsize=(10, 10))
    FigureCanvasAgg(fig)
    for i, chan in enumerate(arr):
        ax = fig.add_subplot(side, side, i + 1)
        ax.set_title(f"{chan.min():.3g},{chan.max():.3g}", fontsize=6)
        ax.imshow(chan)
        ax.axis("off")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename + ".png")
    fig.savefig(path, bbox_inches="tight")
    return path
