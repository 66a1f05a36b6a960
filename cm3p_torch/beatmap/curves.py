"""Slider-curve geometry for osu! beatmaps.

Implements the four osu! slider curve families (linear, multi-bezier,
catmull-rom, perfect-circle arc) with arc-length parameterization, replacing
the external ``slider.curve`` dependency used by the reference
(``/root/reference/cm3p/parsing_cm3p.py:9-10``).  Everything is plain
numpy; curve evaluation happens host-side in the data pipeline, never on TPU.

The public surface mirrors what the event parser needs:

* ``Curve.points``  — the raw control points (including the head).
* ``Curve(t)``      — position at normalized arc-length ``t`` in [0, 1],
                      measured along the curve truncated/extended to
                      ``req_length`` pixels (osu!'s ``pixelLength``).
* ``curve_from_kind(kind, points, req_length)`` — osu! type-char dispatch
  with the stable-fallback rules (P with != 3 points or collinear points
  degrades to bezier).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

Point = tuple[float, float]

# Number of samples used per bezier/catmull segment when building the
# arc-length table. Positions are later quantized to 4 px by the tokenizer,
# so ~0.1 px accuracy is far more than enough.
_SAMPLES_PER_SEGMENT = 64


def _arc_length_tables(verts: np.ndarray):
    """Per-segment vectors/lengths + cumulative arc length of a polyline."""
    seg = np.diff(verts, axis=0)
    seg_len = np.hypot(seg[:, 0], seg[:, 1])
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    return seg, seg_len, cum


def _polyline_position(
    verts: np.ndarray, req_length: float, t: float, tables=None
) -> Point:
    """Position at arc-length ``t * req_length`` along a polyline.

    If the polyline is shorter than ``req_length`` the final segment is
    linearly extrapolated (osu! extends the last segment); degenerate
    zero-length polylines return the last vertex. ``tables`` optionally
    supplies the precomputed ``_arc_length_tables`` — a Curve is evaluated
    many times (head/ticks/repeats/tail), so callers cache them instead of
    re-deriving per call.
    """
    seg, seg_len, cum = tables if tables is not None else _arc_length_tables(verts)
    total = cum[-1]
    target = float(t) * float(req_length)

    if total <= 1e-9:
        x, y = verts[-1]
        return (float(x), float(y))

    if target >= total:
        # extrapolate along the last non-degenerate segment
        for i in range(len(seg_len) - 1, -1, -1):
            if seg_len[i] > 1e-9:
                d = seg[i] / seg_len[i]
                x, y = verts[i + 1] + d * (target - total)
                return (float(x), float(y))
        x, y = verts[-1]
        return (float(x), float(y))

    idx = int(np.searchsorted(cum, target, side="right") - 1)
    idx = min(max(idx, 0), len(seg_len) - 1)
    denom = seg_len[idx] if seg_len[idx] > 1e-9 else 1.0
    frac = (target - cum[idx]) / denom
    x, y = verts[idx] + seg[idx] * frac
    return (float(x), float(y))


def _bezier_points(control: np.ndarray, n: int) -> np.ndarray:
    """Sample an arbitrary-degree Bezier via the matrix (Bernstein) form."""
    degree = len(control) - 1
    if degree == 0:
        return np.repeat(control, n, axis=0)
    ts = np.linspace(0.0, 1.0, n)[:, None]
    # de Casteljau, vectorized over ts
    pts = np.broadcast_to(control[None, :, :], (n, len(control), 2)).copy()
    for _ in range(degree):
        pts = pts[:, :-1, :] * (1.0 - ts)[:, :, None] + pts[:, 1:, :] * ts[:, :, None]
    return pts[:, 0, :]


def _catmull_points(control: np.ndarray, n_per_span: int) -> np.ndarray:
    """Sample a centripetal-free (uniform) Catmull-Rom chain, osu!-style.

    osu! duplicates the first point and mirrors the last for the end spans.
    """
    pts = [control[0]]
    num = len(control)
    for i in range(num - 1):
        p0 = control[i - 1] if i > 0 else control[0]
        p1 = control[i]
        p2 = control[i + 1]
        p3 = control[i + 2] if i + 2 < num else 2 * control[i + 1] - control[i]
        ts = np.linspace(0.0, 1.0, n_per_span)[1:]
        t2 = ts * ts
        t3 = t2 * ts
        for t, a, b in zip(ts, t2, t3):
            pos = 0.5 * (
                2 * p1
                + (-p0 + p2) * t
                + (2 * p0 - 5 * p1 + 4 * p2 - p3) * a
                + (-p0 + 3 * p1 - 3 * p2 + p3) * b
            )
            pts.append(pos)
    return np.asarray(pts)


def get_circle_center(a: Point, b: Point, c: Point) -> Point:
    """Circumcenter of three points; raises ValueError when collinear."""
    ax, ay = a
    bx, by = b
    cx, cy = c
    d = 2.0 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
    if abs(d) < 1e-9:
        raise ValueError("collinear points have no circumcenter")
    a2 = ax * ax + ay * ay
    b2 = bx * bx + by * by
    c2 = cx * cx + cy * cy
    ux = (a2 * (by - cy) + b2 * (cy - ay) + c2 * (ay - by)) / d
    uy = (a2 * (cx - bx) + b2 * (ax - cx) + c2 * (bx - ax)) / d
    return (ux, uy)


class Curve:
    """Base class: control points + position-at-normalized-arc-length."""

    def __init__(self, points: Sequence[Point], req_length: float):
        self.points: list[Point] = [(float(x), float(y)) for x, y in points]
        self.req_length = float(req_length)
        self._verts: np.ndarray | None = None
        self._tables = None

    def _build(self) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, t: float) -> Point:
        if self._verts is None:
            self._verts = np.asarray(self._build(), dtype=np.float64)
            self._tables = _arc_length_tables(self._verts)
        return _polyline_position(self._verts, self.req_length, t, self._tables)


class Linear(Curve):
    """'L' sliders: straight polyline through the control points."""

    def _build(self) -> np.ndarray:
        return np.asarray(self.points, dtype=np.float64)


class Catmull(Curve):
    """'C' sliders: uniform Catmull-Rom chain."""

    def _build(self) -> np.ndarray:
        return _catmull_points(np.asarray(self.points, dtype=np.float64), _SAMPLES_PER_SEGMENT)


class MultiBezier(Curve):
    """'B' sliders: bezier segments split at duplicated (red) anchors."""

    def _build(self) -> np.ndarray:
        control = np.asarray(self.points, dtype=np.float64)
        verts: list[np.ndarray] = []
        seg_start = 0
        for i in range(1, len(control)):
            is_red = np.array_equal(control[i], control[i - 1])
            if is_red or i == len(control) - 1:
                end = i if is_red else i + 1
                segment = control[seg_start:end]
                if len(segment) >= 2:
                    verts.append(_bezier_points(segment, _SAMPLES_PER_SEGMENT * max(1, len(segment) - 1)))
                elif len(segment) == 1:
                    verts.append(segment)
                seg_start = i
        if not verts:
            return control
        return np.concatenate(verts, axis=0)


class Perfect(Curve):
    """'P' sliders: circular arc through exactly three points."""

    def __init__(self, points: Sequence[Point], req_length: float, center: Point | None = None):
        super().__init__(points, req_length)
        self.center = center if center is not None else get_circle_center(*self.points)

    def _build(self) -> np.ndarray:
        (ax, ay), (bx, by), (cx, cy) = self.points
        ux, uy = self.center
        radius = math.hypot(ax - ux, ay - uy)
        theta0 = math.atan2(ay - uy, ax - ux)
        theta1 = math.atan2(by - uy, bx - ux)
        theta2 = math.atan2(cy - uy, cx - ux)

        # direction: go from theta0 towards theta2 passing through theta1
        def _sweep(t_from: float, t_to: float, ccw: bool) -> float:
            d = t_to - t_from
            if ccw:
                while d < 0:
                    d += 2 * math.pi
            else:
                while d > 0:
                    d -= 2 * math.pi
            return d

        ccw_mid = _sweep(theta0, theta1, True)
        ccw_end = _sweep(theta0, theta2, True)
        ccw = ccw_mid <= ccw_end  # midpoint reached before endpoint going ccw
        sweep = _sweep(theta0, theta2, ccw)

        n = max(8, int(abs(sweep) * radius / 2.0))
        n = min(n, 4096)
        angles = theta0 + sweep * np.linspace(0.0, 1.0, n)
        verts = np.stack([ux + radius * np.cos(angles), uy + radius * np.sin(angles)], axis=1)
        return verts


def curve_from_kind(kind: str, points: Sequence[Point], req_length: float) -> Curve:
    """osu! curve-type dispatch with stable fallback rules."""
    if kind == "L":
        return Linear(points, req_length)
    if kind == "C":
        return Catmull(points, req_length)
    if kind == "P":
        if len(points) != 3:
            return MultiBezier(points, req_length)
        try:
            center = get_circle_center(points[0], points[1], points[2])
        except ValueError:
            return MultiBezier(points, req_length)
        return Perfect(points, req_length, center=center)
    # 'B' and anything unknown
    return MultiBezier(points, req_length)
