"""Standalone ``.osu`` beatmap file parser.

A from-scratch replacement for the external ``slider`` library the reference
depends on (``/root/reference/cm3p/parsing_cm3p.py:9``).  Only the surface the
CM3P event parser needs is implemented: hit objects (circles, sliders,
spinners, mania hold notes), timing points with inheritance, difficulty /
metadata fields, and slider end-time/curve math.

Behavioral notes (chosen to match the ``slider`` library semantics the
reference tokens were produced with):

* timing points are *inherited* when ``ms_per_beat < 0``; inherited points
  carry a ``parent`` reference to the most recent uninherited point.
* ``timing_point_at(t)`` returns the last timing point with offset <= t,
  falling back to the first timing point.
* slider duration = ceil(num_beats * ms_per_beat) with
  ``num_beats = pixel_length * repeat / (slider_multiplier * 100 * sv)`` and
  ``sv = clip(-100 / inherited_ms_per_beat, 0.01, 10)``.

All times are float/int **milliseconds** (the reference converts timedeltas
to ms immediately; we skip the detour).
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from os import PathLike
from typing import IO, Optional, Union

from .curves import Curve, curve_from_kind


@dataclass
class TimingPoint:
    offset: float  # ms
    ms_per_beat: float  # negative => inherited (SV) point
    meter: int = 4
    sample_type: int = 0  # osu! "sampleSet" column (0 default, 1 normal, 2 soft, 3 drum)
    sample_index: int = 0
    volume: int = 100
    kiai_mode: bool = False
    parent: Optional["TimingPoint"] = None

    @property
    def inherited(self) -> bool:
        return self.ms_per_beat < 0

    @property
    def bpm(self) -> Optional[float]:
        if self.inherited or self.ms_per_beat == 0 or math.isnan(self.ms_per_beat):
            return None
        return 60000.0 / self.ms_per_beat


@dataclass
class HitObject:
    position: tuple[float, float]
    time: float  # ms
    hitsound: int
    addition: str = "0:0:0:0:"
    new_combo: bool = False


@dataclass
class Circle(HitObject):
    pass


@dataclass
class Spinner(HitObject):
    end_time: float = 0.0


@dataclass
class HoldNote(HitObject):
    end_time: float = 0.0


@dataclass
class Slider(HitObject):
    end_time: float = 0.0
    repeat: int = 1
    pixel_length: float = 0.0
    curve: Curve = None
    edge_sounds: list[int] = field(default_factory=list)
    edge_additions: list[str] = field(default_factory=list)


_TYPE_CIRCLE = 1
_TYPE_SLIDER = 2
_TYPE_NEW_COMBO = 4
_TYPE_SPINNER = 8
_TYPE_HOLD = 128


class Beatmap:
    """Parsed .osu file. Construct via :meth:`from_path` / :meth:`from_string`."""

    def __init__(self):
        self.format_version: int = 14
        self.audio_filename: str = ""
        self.mode: int = 0
        self.title: str = ""
        self.artist: str = ""
        self.creator: str = ""
        self.version: str = ""
        self.source: str = ""
        self.tags: list[str] = []
        self.beatmap_id: Optional[int] = None
        self.beatmap_set_id: Optional[int] = None
        self.hp_drain_rate: float = 5.0
        self.circle_size: float = 5.0
        self.overall_difficulty: float = 5.0
        self.approach_rate: float = 5.0
        self.slider_multiplier: float = 1.4
        self.slider_tick_rate: float = 1.0
        self.timing_points: list[TimingPoint] = []
        self._tp_offset_cache: Optional[tuple[list[float], bool]] = None
        self._hit_objects: list[HitObject] = []

    # -- slider-lib-compatible accessors -------------------------------------

    def hit_objects(self, stacking: bool = False) -> list[HitObject]:
        # Stacking only perturbs render positions; CM3P always parses with
        # stacking=False (parsing_cm3p.py:250), so it is not implemented.
        if stacking:
            raise NotImplementedError("stacking is not used by CM3P")
        return self._hit_objects

    def timing_point_at(self, time_ms: float) -> TimingPoint:
        # Hot path: called 1-3x per hit object by the parser. When offsets are
        # non-decreasing (every real .osu), bisect matches the linear
        # reversed scan ("last point with offset <= t") exactly; unsorted
        # lists keep the scan. Cache keyed by list length so tests that build
        # maps by appending points invalidate it.
        cache = self._tp_offset_cache
        if cache is None or len(cache[0]) != len(self.timing_points):
            offsets = [tp.offset for tp in self.timing_points]
            is_sorted = all(a <= b for a, b in zip(offsets, offsets[1:]))
            cache = self._tp_offset_cache = (offsets, is_sorted)
        offsets, is_sorted = cache
        if is_sorted:
            idx = bisect.bisect_right(offsets, time_ms) - 1
            return self.timing_points[max(idx, 0)]
        for tp in reversed(self.timing_points):
            if tp.offset <= time_ms:
                return tp
        return self.timing_points[0]

    # -- parsing --------------------------------------------------------------

    @classmethod
    def from_path(cls, path: Union[str, PathLike]) -> "Beatmap":
        with open(path, "r", encoding="utf-8-sig", errors="replace") as f:
            return cls.from_string(f.read())

    @classmethod
    def from_file(cls, f: IO[str]) -> "Beatmap":
        return cls.from_string(f.read())

    @classmethod
    def from_string(cls, text: str) -> "Beatmap":
        bm = cls()
        section = None
        timing_lines: list[str] = []
        object_lines: list[str] = []

        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("//"):
                continue
            if line.startswith("osu file format v"):
                try:
                    bm.format_version = int(line.rsplit("v", 1)[1])
                except ValueError:
                    pass
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1].lower()
                continue

            if section in ("general", "metadata", "difficulty", "editor"):
                if ":" not in line:
                    continue
                key, value = line.split(":", 1)
                bm._set_kv(key.strip(), value.strip())
            elif section == "timingpoints":
                timing_lines.append(line)
            elif section == "hitobjects":
                object_lines.append(line)

        bm._parse_timing_points(timing_lines)
        bm._parse_hit_objects(object_lines)
        return bm

    def _set_kv(self, key: str, value: str) -> None:
        if key == "AudioFilename":
            self.audio_filename = value
        elif key == "Mode":
            self.mode = int(value)
        elif key == "Title":
            self.title = value
        elif key == "Artist":
            self.artist = value
        elif key == "Creator":
            self.creator = value
        elif key == "Version":
            self.version = value
        elif key == "Source":
            self.source = value
        elif key == "Tags":
            self.tags = value.split()
        elif key == "BeatmapID":
            self.beatmap_id = _maybe_int(value)
        elif key == "BeatmapSetID":
            self.beatmap_set_id = _maybe_int(value)
        elif key == "HPDrainRate":
            self.hp_drain_rate = float(value)
        elif key == "CircleSize":
            self.circle_size = float(value)
        elif key == "OverallDifficulty":
            self.overall_difficulty = float(value)
        elif key == "ApproachRate":
            self.approach_rate = float(value)
        elif key == "SliderMultiplier":
            self.slider_multiplier = float(value)
        elif key == "SliderTickRate":
            self.slider_tick_rate = float(value)

    def _parse_timing_points(self, lines: list[str]) -> None:
        last_uninherited: Optional[TimingPoint] = None
        for line in lines:
            parts = line.split(",")
            if len(parts) < 2:
                continue
            try:
                offset = float(parts[0])
                msb = float(parts[1])
            except ValueError:
                continue
            meter = int(float(parts[2])) if len(parts) > 2 and parts[2] else 4
            sample_type = int(float(parts[3])) if len(parts) > 3 and parts[3] else 0
            sample_index = int(float(parts[4])) if len(parts) > 4 and parts[4] else 0
            volume = int(float(parts[5])) if len(parts) > 5 and parts[5] else 100
            effects = int(float(parts[7])) if len(parts) > 7 and parts[7] else 0

            tp = TimingPoint(
                offset=offset,
                ms_per_beat=msb,
                meter=meter,
                sample_type=sample_type,
                sample_index=sample_index,
                volume=volume,
                kiai_mode=bool(effects & 1),
            )
            if tp.inherited:
                tp.parent = last_uninherited
            else:
                last_uninherited = tp
            self.timing_points.append(tp)

    def _parse_hit_objects(self, lines: list[str]) -> None:
        for line in lines:
            ho = self._parse_hit_object(line)
            if ho is not None:
                self._hit_objects.append(ho)

    def _parse_hit_object(self, line: str) -> Optional[HitObject]:
        parts = line.split(",")
        if len(parts) < 5:
            return None
        try:
            x = float(parts[0])
            y = float(parts[1])
            time = float(parts[2])
            type_bits = int(parts[3])
            hitsound = int(parts[4])
        except ValueError:
            return None

        new_combo = bool(type_bits & _TYPE_NEW_COMBO)
        pos = (x, y)

        if type_bits & _TYPE_CIRCLE:
            addition = parts[5] if len(parts) > 5 and ":" in parts[5] else "0:0:0:0:"
            return Circle(pos, time, hitsound, addition, new_combo)

        if type_bits & _TYPE_SLIDER:
            return self._parse_slider(parts, pos, time, hitsound, new_combo)

        if type_bits & _TYPE_SPINNER:
            if len(parts) < 6:
                return None
            end_time = float(parts[5])
            addition = parts[6] if len(parts) > 6 and ":" in parts[6] else "0:0:0:0:"
            return Spinner(pos, time, hitsound, addition, new_combo, end_time=end_time)

        if type_bits & _TYPE_HOLD:
            if len(parts) < 6:
                return None
            tail = parts[5]
            if ":" in tail:
                end_str, addition = tail.split(":", 1)
            else:
                end_str, addition = tail, "0:0:0:0:"
            return HoldNote(pos, time, hitsound, addition or "0:0:0:0:", new_combo, end_time=float(end_str))

        return None

    def _parse_slider(
        self, parts: list[str], pos: tuple[float, float], time: float, hitsound: int, new_combo: bool
    ) -> Optional[Slider]:
        if len(parts) < 6:
            return None
        curve_spec = parts[5].split("|")
        kind = curve_spec[0]
        points: list[tuple[float, float]] = [pos]
        for p in curve_spec[1:]:
            if ":" not in p:
                continue
            px, py = p.split(":", 1)
            points.append((float(px), float(py)))

        repeat = int(float(parts[6])) if len(parts) > 6 and parts[6] else 1
        repeat = max(repeat, 1)
        pixel_length = float(parts[7]) if len(parts) > 7 and parts[7] else 0.0

        edge_sounds: list[int] = []
        if len(parts) > 8 and parts[8]:
            try:
                edge_sounds = [int(float(s)) for s in parts[8].split("|") if s != ""]
            except ValueError:
                edge_sounds = []

        edge_additions: list[str] = []
        if len(parts) > 9 and parts[9]:
            edge_additions = [s if ":" in s else "0:0" for s in parts[9].split("|") if s != ""]

        addition = parts[10] if len(parts) > 10 and ":" in parts[10] else "0:0:0:0:"

        # slider velocity math (see module docstring)
        if self.timing_points:
            tp = self.timing_point_at(time)
            if tp.parent is not None:
                sv = -100.0 / tp.ms_per_beat
                sv = min(max(sv, 0.01), 10.0)
                ms_per_beat = tp.parent.ms_per_beat
            else:
                sv = 1.0
                ms_per_beat = tp.ms_per_beat if not tp.inherited else 1000.0
        else:
            sv = 1.0
            ms_per_beat = 1000.0

        pixels_per_beat = self.slider_multiplier * 100.0 * sv
        num_beats = (pixel_length * repeat) / pixels_per_beat if pixels_per_beat > 0 else 0.0
        duration = math.ceil(num_beats * ms_per_beat)
        end_time = time + duration

        curve = curve_from_kind(kind, points, pixel_length)

        return Slider(
            pos,
            time,
            hitsound,
            addition,
            new_combo,
            end_time=end_time,
            repeat=repeat,
            pixel_length=pixel_length,
            curve=curve,
            edge_sounds=edge_sounds,
            edge_additions=edge_additions,
        )


def _maybe_int(value: str) -> Optional[int]:
    try:
        return int(value)
    except ValueError:
        return None
