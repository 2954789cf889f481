"""Wavefront plotting: record band evolution and render heatmaps.

Analog of WFA2-lib's wavefront_plot.c + utils/heatmap.c: tracks, per score
step and per component (M/I1/D1/I2/D2), which DP-matrix cells each
wavefront visited, for visual debugging of band growth, gap-component
spread and heuristic pruning (reference: wavefront_plot.h:55-66 keeps one
heatmap per component plus a behavior heatmap). The M heatmap includes the
cells covered by match extension, re-derived from the sequences exactly
like the reference's simulated extension (wavefront_plot.c:124-185); the
behavior heatmap classifies each cell by which phase first reached it
(compute vs extend -- the reference allocates this heatmap but never
writes it in the vendored snapshot; here it is functional). Text rendering
only (no plotting deps).

A copy of `pywfa_tpu/utils/plot.py`, which the port does not import.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

COMPONENTS = ("M", "I1", "D1", "I2", "D2")


@dataclass
class WavefrontPlot:
    """Accumulates (score, k, offset) samples per wavefront component."""

    pattern_length: int
    text_length: int
    resolution: int = 100  # max grid dimension of the rendered heatmaps
    # M-component per-step records: (score, lo, hi, offsets-in-band)
    steps: List[Tuple[int, int, int, np.ndarray]] = field(default_factory=list)
    # gap-component records, same tuples (reference: i1/d1/i2/d2_heatmap)
    comp_steps: Dict[str, List[Tuple[int, int, int, np.ndarray]]] = field(
        default_factory=lambda: {c: [] for c in COMPONENTS if c != "M"})
    # sequences for simulated match extension (wavefront_plot.c:167-183);
    # None disables extension simulation
    pattern: Optional[bytes] = None
    text: Optional[bytes] = None

    def record(self, score: int, lo: int, hi: int, offsets: np.ndarray) -> None:
        """Record the M-wavefront at `score` (band [lo, hi])."""
        self.steps.append((score, lo, hi, offsets.copy()))

    def record_component(self, comp: str, score: int, lo: int, hi: int,
                         offsets: np.ndarray) -> None:
        """Record a gap wavefront (comp in I1/D1/I2/D2) at `score`."""
        self.comp_steps[comp].append((score, lo, hi, offsets.copy()))

    # -- grids ----------------------------------------------------------
    def _grid_geometry(self):
        ph = max(1, self.pattern_length)
        th = max(1, self.text_length)
        sv = max(1, (ph + self.resolution - 1) // self.resolution)
        sh = max(1, (th + self.resolution - 1) // self.resolution)
        shape = ((ph + sv - 1) // sv, (th + sh - 1) // sh)
        return ph, th, sv, sh, shape

    def _fill(self, grid, phase_grid, records, extend: bool) -> None:
        """First-score-wins heatmap fill, mirroring heatmap_set semantics
        (reference: wavefront_plot.c:141-185: the offset cell plots at
        (v-1, h-1) when both > 0; extension then walks matching chars)."""
        ph, th, sv, sh, _ = self._grid_geometry()
        pat = np.frombuffer(self.pattern, dtype=np.uint8) \
            if self.pattern is not None else None
        txt = np.frombuffer(self.text, dtype=np.uint8) \
            if self.text is not None else None
        for score, lo, hi, offs in records:
            for i, k in enumerate(range(lo, hi + 1)):
                h = int(offs[i])
                if h < 0:
                    continue
                v = h - k
                if v < 0 or v > ph or h < 0 or h > th:
                    continue
                if v > 0 and h > 0:
                    cell = (min(v - 1, ph - 1) // sv, min(h - 1, th - 1) // sh)
                    if grid[cell] < 0:
                        grid[cell] = score
                        if phase_grid is not None:
                            phase_grid[cell] = 1
                # simulated extension (reference: wavefront_plot.c:167-183)
                if extend and pat is not None and txt is not None:
                    while v < ph and h < th and pat[v] == txt[h]:
                        v += 1
                        h += 1
                        cell = ((v - 1) // sv, (h - 1) // sh)
                        if grid[cell] < 0:
                            grid[cell] = score
                            if phase_grid is not None:
                                phase_grid[cell] = 2

    def to_grid(self, component: str = "M") -> np.ndarray:
        """Dense [v-bins, h-bins] grid of the first score at which the
        given component's wavefront visited each cell; -1 = never."""
        _, _, _, _, shape = self._grid_geometry()
        grid = np.full(shape, -1, dtype=np.int64)
        if component == "M":
            self._fill(grid, None, self.steps, extend=True)
        else:
            self._fill(grid, None, self.comp_steps[component], extend=False)
        return grid

    def behavior_grid(self) -> np.ndarray:
        """Per-cell phase that first reached it: 0 = never, 1 = compute
        (a stored wavefront offset), 2 = extend (covered by a simulated
        match-extension run). The functional version of the reference's
        behavior heatmap slot (wavefront_plot.h:65)."""
        _, _, _, _, shape = self._grid_geometry()
        grid = np.full(shape, -1, dtype=np.int64)
        phase = np.zeros(shape, dtype=np.int64)
        self._fill(grid, phase, self.steps, extend=True)
        return phase

    def to_text(self, component: str = "M", width: int = 80) -> str:
        """ASCII heatmap: '.' unvisited, digits/letters = score decile."""
        grid = self.to_grid(component)
        if grid.size == 0:
            return "(empty)"
        smax = max(1, int(grid.max()))
        chars = "0123456789abcdefghijklmnopqrstuvwxyz"
        rows = []
        for r in range(grid.shape[0]):
            row = []
            for c in range(grid.shape[1]):
                s = grid[r, c]
                if s < 0:
                    row.append(".")
                else:
                    row.append(chars[min(len(chars) - 1,
                                         s * (len(chars) - 1) // smax)])
            rows.append("".join(row))
        return "\n".join(rows)

    def print_plot(self, stream=None) -> None:
        """Dump all heatmaps in a sectioned text format (analog of
        wavefront_plot_print, wavefront_plot.c:240-310)."""
        import sys
        stream = stream if stream is not None else sys.stdout
        print(f"# PatternLength {self.pattern_length}", file=stream)
        print(f"# TextLength {self.text_length}", file=stream)
        print("# Heatmap M", file=stream)
        print(self.to_text("M"), file=stream)
        for comp in ("I1", "D1", "I2", "D2"):
            if self.comp_steps[comp]:
                print(f"# Heatmap {comp}", file=stream)
                print(self.to_text(comp), file=stream)
        print("# Heatmap Behavior (1=compute 2=extend)", file=stream)
        bg = self.behavior_grid()
        print("\n".join("".join(".ce"[v] for v in row) for row in bg),
              file=stream)

    def save_tsv(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("component\tscore\tk\toffset\n")
            for comp in COMPONENTS:
                records = self.steps if comp == "M" else self.comp_steps[comp]
                for score, lo, hi, offs in records:
                    for i, k in enumerate(range(lo, hi + 1)):
                        if offs[i] >= 0:
                            fh.write(f"{comp}\t{score}\t{k}\t{int(offs[i])}\n")


def plot_alignment(pattern: str, text: str, resolution: int = 100,
                   **aligner_kwargs) -> WavefrontPlot:
    """Align with the oracle while recording the wavefront evolution."""
    from ..align import WavefrontAligner
    from ..oracle import OracleAligner

    api = WavefrontAligner(backend="numpy", **aligner_kwargs)
    attr = api._attributes()
    bp = pattern.upper().encode()
    bt = text.upper().encode()
    plot = WavefrontPlot(len(pattern), len(text), resolution,
                         pattern=bp, text=bt)
    orc = OracleAligner(attr)
    orc.plot = plot
    orc.align(bp, bt)
    return plot
