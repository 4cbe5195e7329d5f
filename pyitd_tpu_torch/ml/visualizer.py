"""Training observability dashboard: the port's own copy of
``pyitd_tpu/ml/visualizer.py``, numpy only, frames bitwise the JAX
package's.

A char-grid of per-token predictions (green = correct, orange = wrong,
brightness decaying with staleness) plus an EWMA loss bar, rendered into a
plain RGB numpy array: headless-safe, testable, and displayable with
PIL/matplotlib when available.
"""
from __future__ import annotations

import numpy as np

__all__ = ["MatrixDashboard", "LiveSink", "flame_attention_panel"]

_GREEN = np.array([60, 220, 100], np.float32)
_ORANGE = np.array([240, 150, 40], np.float32)
_BAR = np.array([90, 160, 255], np.float32)


class MatrixDashboard:
    """Rolling per-token correctness grid + EWMA loss bar.

    ``update(pred, target, loss)`` ingests one step's token predictions
    (1-D int arrays) and returns the rendered RGB image (H, W, 3) uint8.
    """

    def __init__(self, n_cols: int = 64, n_rows: int = 24, cell: int = 6,
                 ewma: float = 0.98, decay: float = 0.9):
        self.n_cols = n_cols
        self.n_rows = n_rows
        self.cell = cell
        self.ewma = ewma
        self.decay = decay
        self.loss_avg: float | None = None
        self.loss_hist: list[float] = []
        self._correct = np.zeros((n_rows, n_cols), np.float32)
        self._fresh = np.zeros((n_rows, n_cols), np.float32)
        self._row = 0

    def update(self, pred, target, loss: float) -> np.ndarray:
        pred = np.asarray(pred).reshape(-1)[: self.n_cols]
        target = np.asarray(target).reshape(-1)[: self.n_cols]
        correct = (pred == target).astype(np.float32)

        self._fresh *= self.decay
        row = self._row % self.n_rows
        self._correct[row, : correct.size] = correct
        self._fresh[row, : correct.size] = 1.0
        self._row += 1

        loss = float(loss)
        self.loss_avg = loss if self.loss_avg is None else (
            self.ewma * self.loss_avg + (1 - self.ewma) * loss
        )
        self.loss_hist.append(self.loss_avg)
        return self.render()

    def render(self) -> np.ndarray:
        c = self.cell
        grid = np.zeros((self.n_rows, self.n_cols, 3), np.float32)
        bright = 0.25 + 0.75 * self._fresh[..., None]
        grid += np.where(
            self._correct[..., None] > 0, _GREEN[None, None], _ORANGE[None, None]
        ) * bright
        img = np.kron(grid, np.ones((c, c, 1), np.float32))

        # loss bar footer: EWMA history rendered as a sparkline strip
        bar_h = 2 * c
        strip = np.zeros((bar_h, img.shape[1], 3), np.float32)
        if self.loss_hist:
            hist = np.asarray(self.loss_hist[-self.n_cols * c :], np.float32)
            hist = hist[-img.shape[1]:]
            lo, hi = float(hist.min()), float(hist.max())
            span = (hi - lo) or 1.0
            ys = ((1.0 - (hist - lo) / span) * (bar_h - 1)).astype(int)
            xs = np.arange(img.shape[1] - hist.size, img.shape[1])
            strip[ys, xs] = _BAR
        out = np.concatenate([img, strip], axis=0)
        return np.clip(out, 0, 255).astype(np.uint8)

    def to_pil(self):  # pragma: no cover - optional dependency path
        from PIL import Image

        return Image.fromarray(self.render())

    def live(self):
        """Attach a live in-notebook sink (the reference's ipywidgets
        ``Image`` display, ``visualizer.py:16-175``): returns a
        :class:`LiveSink` whose ``push()`` re-renders into the displayed
        widget after every ``update()``.  Requires ipywidgets; headless
        environments keep using :meth:`update`/:meth:`render` directly."""
        return LiveSink(self)


class LiveSink:
    """ipywidgets Image sink for :class:`MatrixDashboard` — "watch
    training live" in a notebook.  Constructed via
    :meth:`MatrixDashboard.live`; ``push(pred, target, loss)`` ingests a
    step and refreshes the displayed widget in place."""

    def __init__(self, dash: MatrixDashboard):
        try:  # pragma: no cover - notebook-only dependency
            import ipywidgets
            from IPython.display import display
        except ImportError as e:  # gate, don't fail import of this module
            raise ImportError(
                "MatrixDashboard.live() needs ipywidgets/IPython (notebook "
                "environments); use update()/render() headlessly"
            ) from e
        self.dash = dash
        self._widget = ipywidgets.Image(format="png")
        self._display = display
        self._shown = False

    def _encode(self, frame) -> bytes:  # pragma: no cover - PIL path
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="PNG")
        return buf.getvalue()

    def push(self, pred, target, loss: float):  # pragma: no cover
        frame = self.dash.update(pred, target, loss)
        self._widget.value = self._encode(frame)
        if not self._shown:
            self._display(self._widget)
            self._shown = True
        return frame


def flame_attention_panel(attn: np.ndarray, cell: int = 4) -> np.ndarray:
    """Flame-colored attention-matrix panel (the TapeTransformer notebook's
    visualization): maps weights through a black->red->orange->yellow->white
    ramp.  ``attn``: (T, T) or (H, T, T) (heads tiled horizontally).
    Returns (H*, W*, 3) uint8."""
    a = np.asarray(attn, np.float32)
    if a.ndim == 2:
        a = a[None]
    lo, hi = float(a.min()), float(a.max())
    x = (a - lo) / ((hi - lo) or 1.0)

    # piecewise flame ramp
    r = np.clip(x * 3.0, 0, 1)
    g = np.clip(x * 3.0 - 1.0, 0, 1)
    b = np.clip(x * 3.0 - 2.0, 0, 1)
    img = np.stack([r, g, b], axis=-1) * 255.0  # (H, T, T, 3)

    tiles = [np.kron(img[h], np.ones((cell, cell, 1), np.float32)) for h in range(img.shape[0])]
    sep = np.full((tiles[0].shape[0], 2, 3), 40.0, np.float32)
    out = tiles[0]
    for tl in tiles[1:]:
        out = np.concatenate([out, sep, tl], axis=1)
    return np.clip(out, 0, 255).astype(np.uint8)
