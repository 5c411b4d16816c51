"""Interactive 2D visualisation: the reference's Visualizor2D contract.

Counterpart of ``feature_detector_tpu/io/visualize.py``: ``show_image`` and
``wait_key`` on top of matplotlib where it can open windows, and a window
registry (plus an optional PNG per window) on a host without a display, so
that demo code written against them runs on a headless host unchanged.

Two faults of the JAX package's copy are repaired here:

- backends are classified by their exact name, so the GUI backends whose
  names end in "agg" (TkAgg, QtAgg, GTK4Agg, wxAgg) count as interactive;
- a display is evidenced by ``DISPLAY`` or ``WAYLAND_DISPLAY``, and is
  taken as present on macOS and Windows.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Optional

import numpy as np

# Backends that cannot open windows, by exact (lower-case) name.
NON_INTERACTIVE_BACKENDS = frozenset({"agg", "cairo", "pdf", "pgf", "ps", "svg", "template", "eps"})

# Title -> last image shown, in display order (dict preserves insertion).
_WINDOWS: Dict[str, np.ndarray] = {}
_INTERACTIVE: Optional[bool] = None  # resolved lazily


def _plt():
    import matplotlib.pyplot as plt

    return plt


def display_present() -> bool:
    """A display server is reachable: macOS and Windows always, elsewhere
    when ``DISPLAY`` (X11) or ``WAYLAND_DISPLAY`` is set."""
    return (sys.platform == "darwin" or os.name == "nt"
            or bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")))


def backend_is_interactive(backend: str) -> bool:
    """Whether a matplotlib backend name (any case) opens windows."""
    name = backend.lower()
    return name not in NON_INTERACTIVE_BACKENDS and not name.startswith("module://matplotlib_inline")


def interactive_available() -> bool:
    """True when matplotlib can open real windows on this host.

    ``FD_NO_DISPLAY`` forces False; so do a non-interactive backend and the
    absence of a display.  ``show_image`` then records images in the
    registry instead of opening windows."""
    global _INTERACTIVE
    if _INTERACTIVE is not None:
        return _INTERACTIVE
    if os.environ.get("FD_NO_DISPLAY"):
        _INTERACTIVE = False
        return False
    try:
        import matplotlib

        _INTERACTIVE = backend_is_interactive(matplotlib.get_backend()) and display_present()
    except ImportError:
        _INTERACTIVE = False
    return _INTERACTIVE


def show_image(title: str, image: np.ndarray, out_dir: Optional[str] = None) -> None:
    """Visualizor2D::ShowImage: shows ``image`` (grayscale [H, W] or RGB
    [H, W, 3] uint8) in the window ``title``; showing a title again updates
    that window.  The image is also kept in the registry and, with
    ``out_dir``, written to ``<out_dir>/<slug(title)>.png``."""
    img = np.asarray(image)
    _WINDOWS[title] = img
    if out_dir is not None:
        from .images import save_image, to_rgb

        slug = "".join(c if c.isalnum() else "_" for c in title.strip().lower())
        save_image(os.path.join(out_dir, f"{slug}.png"), img if img.ndim == 3 else to_rgb(img))
    if not interactive_available():
        return
    plt = _plt()
    fig = plt.figure(title)
    fig.clf()
    ax = fig.add_subplot(111)
    ax.imshow(img, cmap=None if img.ndim == 3 else "gray")
    ax.set_title(title)
    ax.axis("off")
    plt.show(block=False)
    plt.pause(0.001)


def wait_key(delay_ms: int = 0) -> int:
    """Visualizor2D::WaitKey: blocks until a key or button press in a window
    (``delay_ms`` 0: without a time limit).  Returns 0 on a press, -1 on a
    timeout or without windows."""
    if not interactive_available():
        return -1
    plt = _plt()
    if not plt.get_fignums():
        return -1
    timeout = None if delay_ms == 0 else max(delay_ms, 1) / 1e3
    pressed = plt.figure(plt.get_fignums()[-1]).waitforbuttonpress(timeout=timeout)
    return -1 if pressed is None else 0


def windows() -> Dict[str, np.ndarray]:
    """The registry of images shown so far (title -> image), in display order."""
    return dict(_WINDOWS)


def close_all() -> None:
    """Closes every window and clears the registry."""
    _WINDOWS.clear()
    if interactive_available():
        _plt().close("all")
