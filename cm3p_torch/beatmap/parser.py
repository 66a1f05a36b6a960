"""Beatmap → event-group parser.

Lowers a parsed :class:`~cm3p_torch.beatmap.osu.Beatmap` into the time-ordered
``Group`` stream the tokenizer consumes. Behavioral parity target:
``/root/reference/cm3p/parsing_cm3p.py:197-752`` (per-object parsing, timing
grid synthesis, kiai toggles, BPM-normalized mania scroll speeds, snapping
detection, hitsound inheritance, DT speed scaling).

Everything here is host-side Python; it runs inside data-loader workers and
never touches JAX.
"""
from __future__ import annotations

import math
from os import PathLike
from typing import IO, Optional, Union

import numpy as np

from ..utils.io import JsonConfigMixin
from .events import EventType, Group, get_median_mpb_beatmap, merge_groups, speed_groups
from .osu import Beatmap, Circle, HoldNote, Slider, Spinner, TimingPoint
from .curves import Catmull, Linear, MultiBezier, Perfect

BeatmapLike = Union[str, PathLike, IO[str], Beatmap]


def load_beatmap(beatmap: BeatmapLike) -> Beatmap:
    """Load a beatmap from a path, open file, or already-parsed object."""
    if isinstance(beatmap, Beatmap):
        return beatmap
    if hasattr(beatmap, "read"):
        return Beatmap.from_file(beatmap)
    return Beatmap.from_path(beatmap)


def get_song_length(
    samples: Optional[np.ndarray] = None,
    sample_rate: Optional[int] = None,
    beatmap: Union[Beatmap, list[TimingPoint], None] = None,
) -> float:
    """Song length in seconds, from audio if available else beatmap timing.

    Mirrors parsing_cm3p.py:174-194 including its small end-buffers.
    """
    if samples is not None and sample_rate is not None:
        return len(samples) / sample_rate

    if beatmap is None:
        return 0

    if isinstance(beatmap, Beatmap) and len(beatmap.hit_objects(stacking=False)) > 0:
        last_ho = beatmap.hit_objects(stacking=False)[-1]
        last_time = last_ho.end_time if hasattr(last_ho, "end_time") else last_ho.time
        return last_time / 1000.0 + 0.000999

    timing = beatmap.timing_points if isinstance(beatmap, Beatmap) else beatmap
    if len(timing) == 0:
        return 0
    return timing[-1].offset / 1000.0 + 0.01


class BeatmapEventParser(JsonConfigMixin):
    """Parse beatmaps into tokenizable event groups.

    Args:
        emit_mania_column: the reference assigns the mania column to a dead
            attribute (parsing_cm3p.py:501 writes ``group.column`` while the
            tokenizer reads ``mania_column``), so column tokens never reach
            the model. ``False`` (default) reproduces that behavior for
            checkpoint parity; ``True`` fixes it.
    """

    config_name = "parser_config.json"
    config_aliases = ("preprocessor_config.json",)  # HF/reference layout

    def __init__(
        self,
        add_timing: bool = True,
        add_snapping: bool = True,
        add_timing_points: bool = True,
        add_hitsounds: bool = True,
        add_distances: bool = True,
        add_positions: bool = True,
        add_kiai: bool = True,
        add_sv: bool = True,
        add_mania_sv: bool = True,
        mania_bpm_normalized_scroll_speed: bool = True,
        slider_version: int = 2,
        emit_mania_column: bool = False,
        **_unused,
    ):
        self.add_timing = add_timing
        self.add_snapping = add_snapping
        self.add_timing_points = add_timing_points
        self.add_hitsounds = add_hitsounds
        self.add_distances = add_distances
        self.add_positions = add_positions
        self.add_kiai = add_kiai
        self.add_sv = add_sv
        self.add_mania_sv = add_mania_sv
        self.mania_bpm_normalized_scroll_speed = mania_bpm_normalized_scroll_speed
        self.slider_version = slider_version
        self.emit_mania_column = emit_mania_column

    def get_config(self) -> dict:
        return {
            "add_timing": self.add_timing,
            "add_snapping": self.add_snapping,
            "add_timing_points": self.add_timing_points,
            "add_hitsounds": self.add_hitsounds,
            "add_distances": self.add_distances,
            "add_positions": self.add_positions,
            "add_kiai": self.add_kiai,
            "add_sv": self.add_sv,
            "add_mania_sv": self.add_mania_sv,
            "mania_bpm_normalized_scroll_speed": self.mania_bpm_normalized_scroll_speed,
            "slider_version": self.slider_version,
            "emit_mania_column": self.emit_mania_column,
        }

    # ------------------------------------------------------------------ main

    def parse_beatmap(
        self,
        beatmap: BeatmapLike,
        speed: float = 1.0,
        song_length: Optional[float] = None,
    ) -> list[Group]:
        """Parse a beatmap into a time-sorted list of event groups."""
        beatmap = load_beatmap(beatmap)
        hit_objects = beatmap.hit_objects(stacking=False)
        last_pos = (256.0, 192.0)
        groups: list[Group] = []

        for ho in hit_objects:
            if isinstance(ho, Circle):
                last_pos = self._parse_circle(ho, groups, last_pos, beatmap)
            elif isinstance(ho, Slider):
                if beatmap.mode == 1:
                    self._parse_drumroll(ho, groups, beatmap)
                else:
                    last_pos = self._parse_slider(ho, groups, last_pos, beatmap)
            elif isinstance(ho, Spinner):
                if beatmap.mode == 1:
                    self._parse_denden(ho, groups, beatmap)
                else:
                    last_pos = self._parse_spinner(ho, groups, beatmap)
            elif isinstance(ho, HoldNote):
                last_pos = self._parse_hold_note(ho, groups, beatmap)

        if len(groups) > 0:
            groups = sorted(groups, key=lambda g: g.time)
        result = list(groups)

        if self.add_mania_sv and beatmap.mode == 3:
            result = merge_groups(self.parse_scroll_speeds(beatmap), result)

        if self.add_kiai:
            result = merge_groups(self.parse_kiai(beatmap), result)

        if self.add_timing:
            result = merge_groups(self.parse_timing(beatmap, song_length=song_length), result)

        if speed != 1.0:
            result = speed_groups(result, speed)

        return result

    # ----------------------------------------------------------- sub-streams

    def parse_scroll_speeds(self, beatmap: Beatmap, speed: float = 1.0) -> list[Group]:
        """BPM-normalized scroll speed changes (mania)."""
        normalized = self.mania_bpm_normalized_scroll_speed
        groups: list[Group] = []
        median_mpb = get_median_mpb_beatmap(beatmap)
        mpb = median_mpb
        last_speed = -1.0

        tps = beatmap.timing_points
        for i, tp in enumerate(tps):
            if tp.parent is None:
                mpb = tp.ms_per_beat
                scroll_speed = 1.0
            else:
                scroll_speed = -100.0 / tp.ms_per_beat

            if i == len(tps) - 1 or tps[i + 1].offset > tp.offset:
                value = scroll_speed * median_mpb / mpb if normalized else scroll_speed
                if value != last_speed or last_speed == -1:
                    self._add_group(
                        EventType.SCROLL_SPEED_CHANGE,
                        groups,
                        time=tp.offset,
                        beatmap=beatmap,
                        scroll_speed=value,
                    )
                last_speed = value

        if speed != 1.0:
            groups = speed_groups(groups, speed)
        return groups

    def parse_kiai(self, beatmap: Beatmap, speed: float = 1.0) -> list[Group]:
        groups: list[Group] = []
        kiai = False
        for tp in beatmap.timing_points:
            if tp.kiai_mode == kiai:
                continue
            self._add_group(
                EventType.KIAI_ON if tp.kiai_mode else EventType.KIAI_OFF,
                groups,
                time=tp.offset,
                beatmap=beatmap,
            )
            kiai = tp.kiai_mode
        if speed != 1.0:
            groups = speed_groups(groups, speed)
        return groups

    def parse_timing(
        self,
        beatmap: Union[Beatmap, list[TimingPoint]],
        speed: float = 1.0,
        song_length: Optional[float] = None,
    ) -> list[Group]:
        """Synthesize the beat/measure/timing-point grid."""
        timing = beatmap.timing_points if isinstance(beatmap, Beatmap) else beatmap
        assert len(timing) > 0, "No timing points found in beatmap."

        groups: list[Group] = []
        last_time = song_length if song_length is not None else get_song_length(beatmap=beatmap)
        last_time = int(last_time * 1000)

        timing_points = [tp for tp in timing if tp.bpm]
        for i, tp in enumerate(timing_points):
            next_tp = timing_points[i + 1] if i + 1 < len(timing_points) else None
            next_time = next_tp.offset - 10 if next_tp else last_time
            start_time = tp.offset
            time = start_time
            measure_counter = 0
            beat_delta = tp.ms_per_beat
            meter = tp.meter if tp.meter > 0 else 4
            while time <= next_time:
                if self.add_timing_points and measure_counter == 0:
                    event_type = EventType.TIMING_POINT
                elif measure_counter % meter == 0:
                    event_type = EventType.MEASURE
                else:
                    event_type = EventType.BEAT

                self._add_group(event_type, groups, time=time, add_snap=False)

                if beat_delta <= 10:
                    break
                measure_counter += 1
                time = start_time + measure_counter * beat_delta

        if speed != 1.0:
            groups = speed_groups(groups, speed)
        return groups

    # ------------------------------------------------------------- utilities

    @staticmethod
    def uninherited_point_at(time_ms: float, beatmap: Beatmap) -> TimingPoint:
        tp = beatmap.timing_point_at(time_ms)
        return tp if tp.parent is None else tp.parent

    @staticmethod
    def hitsound_point_at(time_ms: float, beatmap: Beatmap) -> TimingPoint:
        return beatmap.timing_point_at(time_ms + 5.0)

    def scroll_speed_at(self, time_ms: float, beatmap: Beatmap) -> float:
        return self.tp_to_scroll_speed(beatmap.timing_point_at(time_ms))

    def tp_to_scroll_speed(self, tp: TimingPoint) -> float:
        if tp.parent is None or tp.ms_per_beat >= 0 or math.isnan(tp.ms_per_beat):
            return 1.0
        return float(min(max(-100.0 / tp.ms_per_beat, 0.01), 10.0))

    def _get_snapping(self, time_ms: float, beatmap: Beatmap, add_snap: bool = True) -> Optional[int]:
        """Detect the beat snap divisor (1/1 .. 1/16, 2 ms tolerance).

        ``beats`` replicates the reference's timedelta chain bit-for-bit
        (parsing_cm3p.py:427: ``(time - tp.offset).total_seconds() * 1000``):
        times quantize to integer microseconds, subtract exactly, then pay
        ONE float division by 1e6 and a *1000 — which lands one ulp away
        from our exact float milliseconds often enough to flip the 2 ms
        tolerance at boundary cases (found by the perf-corpus differential:
        a repeat-edge at exactly 2.000 ms off the 1/6 grid)."""
        if not add_snap or not self.add_snapping:
            return None
        tp = self.uninherited_point_at(time_ms, beatmap)
        d_us = round(time_ms * 1000.0) - round(tp.offset * 1000.0)
        beats = (d_us / 1e6) * 1000.0 / tp.ms_per_beat
        snapping = 0
        for i in range(1, 17):
            if abs(beats - round(beats * i) / i) * tp.ms_per_beat < 2:
                snapping = i
                break
        return snapping

    def _get_hitsounds(
        self, time_ms: float, hitsound: int, addition: str, beatmap: Beatmap
    ) -> tuple[int, int, int, int]:
        """Resolve hitsound bits, sample sets, and volume with inheritance."""
        tp = self.hitsound_point_at(time_ms, beatmap)
        tp_sample_set = tp.sample_type if tp.sample_type != 0 else 2  # inherit to soft
        split = addition.split(":")
        sample_set = int(split[0]) if split[0] != "0" else tp_sample_set
        addition_set = int(split[1]) if split[1] != "0" else sample_set
        volume = int(split[3]) if len(split) > 3 and split[3] != "0" else tp.volume

        sample_set = sample_set if 0 < sample_set < 4 else 1
        addition_set = addition_set if 0 < addition_set < 4 else 1
        hitsound = hitsound & 14  # whistle/finish/clap bits only
        volume = int(min(max(volume, 0), 100))
        return hitsound, sample_set, addition_set, volume

    def _get_position(
        self, pos: tuple, last_pos: tuple
    ) -> tuple[Optional[int], Optional[int], Optional[int], tuple]:
        x = y = dist = None
        if self.add_distances:
            # same float64 ops as np.linalg.norm on a 2-vector (dx*dx+dy*dy
            # then sqrt) without the per-object array boxing
            dx = float(pos[0]) - float(last_pos[0])
            dy = float(pos[1]) - float(last_pos[1])
            dist = int(math.sqrt(dx * dx + dy * dy))
        if self.add_positions:
            x = int(pos[0])
            y = int(pos[1])
        return x, y, dist, pos

    @staticmethod
    def _get_mania_column(pos: tuple, columns: int) -> int:
        return int(min(max(pos[0] / 512 * columns, 0), columns - 1))

    def _add_group(
        self,
        event_type: EventType,
        groups: list[Group],
        time: float,
        *,
        beatmap: Beatmap = None,
        add_snap: bool = True,
        has_time: bool = True,
        pos: Optional[tuple] = None,
        last_pos: Optional[tuple] = None,
        new_combo: bool = False,
        hitsound_ref_times: Optional[list[float]] = None,
        hitsounds: Optional[list[int]] = None,
        additions: Optional[list[str]] = None,
        scroll_speed: Optional[float] = None,
    ) -> Optional[tuple]:
        group = Group(event_type=event_type, time=int(time + 1e-5))

        if has_time:
            group.has_time = True
            group.snapping = self._get_snapping(time, beatmap, add_snap)
        if pos is not None:
            if beatmap.mode in (0, 2):
                x, y, dist, last_pos = self._get_position(pos, last_pos)
                group.x = x
                group.y = y
                group.distance = dist
            elif beatmap.mode == 3 and self.emit_mania_column:
                group.mania_column = self._get_mania_column(pos, int(beatmap.circle_size))
        if new_combo and beatmap.mode in (0, 2):
            group.new_combo = True
        if scroll_speed is not None:
            group.scroll_speed = scroll_speed
        if hitsound_ref_times is not None and self.add_hitsounds:
            for i, ref_time in enumerate(hitsound_ref_times):
                h, s, a, v = self._get_hitsounds(ref_time, hitsounds[i], additions[i], beatmap)
                group.hitsounds.append(h)
                group.samplesets.append(s)
                group.additions.append(a)
                group.volumes.append(v)

        groups.append(group)
        return last_pos

    # ------------------------------------------------------------ per object

    def _parse_circle(self, circle: Circle, groups, last_pos, beatmap: Beatmap):
        return self._add_group(
            EventType.CIRCLE,
            groups,
            time=circle.time,
            beatmap=beatmap,
            pos=circle.position,
            last_pos=last_pos,
            new_combo=circle.new_combo,
            hitsound_ref_times=[circle.time],
            hitsounds=[circle.hitsound],
            additions=[circle.addition],
            scroll_speed=self.scroll_speed_at(circle.time, beatmap) if beatmap.mode == 1 else None,
        )

    def _parse_slider(self, slider: Slider, groups, last_pos, beatmap: Beatmap):
        if len(slider.curve.points) >= 100:  # degenerate art sliders
            return last_pos

        last_pos = self._add_group(
            EventType.SLIDER_HEAD,
            groups,
            time=slider.time,
            beatmap=beatmap,
            pos=slider.position,
            last_pos=last_pos,
            new_combo=slider.new_combo,
            hitsound_ref_times=[slider.time],
            hitsounds=[slider.edge_sounds[0] if len(slider.edge_sounds) > 0 else 0],
            additions=[slider.edge_additions[0] if len(slider.edge_additions) > 0 else "0:0"],
            scroll_speed=self.scroll_speed_at(slider.time, beatmap) if self.add_sv else None,
        )

        duration = (slider.end_time - slider.time) / slider.repeat
        cpc = len(slider.curve.points)

        def add_anchor(event_type: EventType, i: int, last_pos):
            anchor_time = (
                slider.time + i / (cpc - 1) * duration if self.slider_version == 1 else slider.time
            )
            return self._add_group(
                event_type,
                groups,
                time=anchor_time,
                beatmap=beatmap,
                has_time=False,
                pos=slider.curve.points[i],
                last_pos=last_pos,
            )

        def append_control_points(event_type: EventType, last_pos):
            for i in range(1, cpc - 1):
                last_pos = add_anchor(event_type, i, last_pos)
            return last_pos

        curve = slider.curve
        if isinstance(curve, Linear):
            last_pos = append_control_points(EventType.RED_ANCHOR, last_pos)
        elif isinstance(curve, Catmull):
            last_pos = append_control_points(EventType.CATMULL_ANCHOR, last_pos)
        elif isinstance(curve, Perfect):
            last_pos = append_control_points(EventType.PERFECT_ANCHOR, last_pos)
        elif isinstance(curve, MultiBezier):
            for i in range(1, cpc - 1):
                if curve.points[i] == curve.points[i + 1]:
                    last_pos = add_anchor(EventType.RED_ANCHOR, i, last_pos)
                elif curve.points[i] != curve.points[i - 1]:
                    last_pos = add_anchor(EventType.BEZIER_ANCHOR, i, last_pos)

        if self.slider_version == 2:
            last_pos = self._add_group(
                EventType.LAST_ANCHOR,
                groups,
                time=slider.time,
                beatmap=beatmap,
                has_time=False,
                pos=slider.curve.points[-1],
                last_pos=last_pos,
            )

        # body hitsound + intermediate repeat-edge hitsounds
        last_pos = self._add_group(
            EventType.SLIDER_END,
            groups,
            time=slider.time + duration,
            beatmap=beatmap,
            pos=slider.curve.points[-1] if self.slider_version == 1 else None,
            last_pos=last_pos,
            hitsound_ref_times=[slider.time + 1.0] + [slider.time + i * duration for i in range(1, slider.repeat)],
            hitsounds=[slider.hitsound]
            + [slider.edge_sounds[i] if len(slider.edge_sounds) > i else 0 for i in range(1, slider.repeat)],
            additions=[slider.addition]
            + [slider.edge_additions[i] if len(slider.edge_additions) > i else "0:0" for i in range(1, slider.repeat)],
        )

        return self._add_group(
            EventType.REPEAT_END,
            groups,
            time=slider.end_time,
            beatmap=beatmap,
            pos=slider.curve(1),
            last_pos=last_pos,
            hitsound_ref_times=[slider.end_time],
            hitsounds=[slider.edge_sounds[-1] if len(slider.edge_sounds) > 0 else 0],
            additions=[slider.edge_additions[-1] if len(slider.edge_additions) > 0 else "0:0"],
        )

    def _parse_spinner(self, spinner: Spinner, groups, beatmap: Beatmap):
        self._add_group(EventType.SPINNER, groups, time=spinner.time, beatmap=beatmap)
        self._add_group(
            EventType.SPINNER_END,
            groups,
            time=spinner.end_time,
            beatmap=beatmap,
            hitsound_ref_times=[spinner.end_time],
            hitsounds=[spinner.hitsound],
            additions=[spinner.addition],
        )
        return (256.0, 192.0)

    def _parse_hold_note(self, hold_note: HoldNote, groups, beatmap: Beatmap):
        pos = hold_note.position
        self._add_group(
            EventType.HOLD_NOTE,
            groups,
            time=hold_note.time,
            beatmap=beatmap,
            pos=pos,
            hitsound_ref_times=[hold_note.time],
            hitsounds=[hold_note.hitsound],
            additions=[hold_note.addition],
        )
        self._add_group(
            EventType.HOLD_NOTE_END,
            groups,
            time=hold_note.end_time,
            beatmap=beatmap,
            pos=pos,
        )
        return pos

    def _parse_drumroll(self, slider: Slider, groups, beatmap: Beatmap):
        self._add_group(
            EventType.DRUMROLL,
            groups,
            time=slider.time,
            beatmap=beatmap,
            hitsound_ref_times=[slider.time],
            hitsounds=[slider.hitsound],  # drumrolls have no edge hitsounds
            additions=[slider.addition],
            scroll_speed=self.scroll_speed_at(slider.time, beatmap),
        )
        self._add_group(EventType.DRUMROLL_END, groups, time=slider.end_time, beatmap=beatmap)

    def _parse_denden(self, spinner: Spinner, groups, beatmap: Beatmap):
        self._add_group(
            EventType.DENDEN,
            groups,
            time=spinner.time,
            beatmap=beatmap,
            hitsound_ref_times=[spinner.time],
            hitsounds=[spinner.hitsound],
            additions=[spinner.addition],
            scroll_speed=self.scroll_speed_at(spinner.time, beatmap),
        )
        self._add_group(EventType.DENDEN_END, groups, time=spinner.end_time, beatmap=beatmap)
