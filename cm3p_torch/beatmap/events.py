"""Event stream model for CM3P beatmap tokenization.

Defines the 23 event types and the ``Group`` record each beatmap element is
lowered to, plus stream utilities (time-ordered merge, speed scaling, median
ms-per-beat).  Parity target: ``/root/reference/cm3p/parsing_cm3p.py:16-155``.

All times are integer/float milliseconds.
"""
from __future__ import annotations

import dataclasses
import math
from enum import Enum

from .osu import Beatmap, HoldNote, TimingPoint


class EventType(Enum):
    CIRCLE = "circle"
    SPINNER = "spinner"
    SPINNER_END = "spinner_end"
    SLIDER_HEAD = "slider_head"
    BEZIER_ANCHOR = "bezier_anchor"
    PERFECT_ANCHOR = "perfect_anchor"
    CATMULL_ANCHOR = "catmull_anchor"
    RED_ANCHOR = "red_anchor"
    LAST_ANCHOR = "last_anchor"
    SLIDER_END = "slider_end"
    REPEAT_END = "repeat_end"
    BEAT = "beat"
    MEASURE = "measure"
    TIMING_POINT = "timing_point"
    KIAI_ON = "kiai_on"
    KIAI_OFF = "kiai_off"
    HOLD_NOTE = "hold_note"
    HOLD_NOTE_END = "hold_note_end"
    SCROLL_SPEED_CHANGE = "scroll_speed_change"
    DRUMROLL = "drumroll"
    DRUMROLL_END = "drumroll_end"
    DENDEN = "denden"
    DENDEN_END = "denden_end"


EVENT_TYPES_WITH_NEW_COMBO = [
    EventType.CIRCLE,
    EventType.SLIDER_HEAD,
]


@dataclasses.dataclass(slots=True)
class Group:
    """One tokenizable beatmap event with its attached attributes.

    ``slots=True``: ~100k Groups are created per track on the data-loader
    hot path; slots cut the per-instance dict allocation and speed
    attribute access in the parser/tokenizer loops.
    """

    event_type: EventType = None
    time: int = 0
    has_time: bool = False
    snapping: int = None
    distance: int = None
    x: int = None
    y: int = None
    mania_column: int = None
    new_combo: bool = False
    hitsounds: list[int] = dataclasses.field(default_factory=list)
    samplesets: list[int] = dataclasses.field(default_factory=list)
    additions: list[int] = dataclasses.field(default_factory=list)
    volumes: list[int] = dataclasses.field(default_factory=list)
    scroll_speed: float = None


def merge_groups(groups1: list[Group], groups2: list[Group]) -> list[Group]:
    """Merge two time-sorted group lists, preserving relative order.

    Replicates the reference's falsy-time carry-forward (a group at t=0
    keeps the previous comparison time) so merged orderings are identical
    (parsing_cm3p.py:66-96).
    """
    merged: list[Group] = []
    i = j = 0
    t1 = -math.inf
    t2 = -math.inf
    while i < len(groups1) and j < len(groups2):
        t1 = groups1[i].time or t1
        t2 = groups2[j].time or t2
        if t1 <= t2:
            merged.append(groups1[i])
            i += 1
        else:
            merged.append(groups2[j])
            j += 1
    merged.extend(groups1[i:])
    merged.extend(groups2[j:])
    return merged


def speed_groups(groups: list[Group], speed: float) -> list[Group]:
    """Apply a rate multiplier (DT augmentation) to every group time."""
    for group in groups:
        group.time = int(group.time / speed)
    return groups


def _td_floor_seconds_ms(ms: float) -> int:
    """``int(timedelta(milliseconds=ms).seconds * 1000)`` without timedelta.

    The reference's median-mpb code quantizes offsets through
    ``timedelta.seconds`` (parsing_cm3p.py:121,132), i.e. whole seconds within
    the day component. We reproduce that exactly, including the negative-time
    wraparound behavior of timedelta normalization.
    """
    days = math.floor(ms / 86_400_000.0)
    rem_ms = ms - days * 86_400_000.0
    return int(rem_ms // 1000) * 1000


def get_median_mpb_beatmap(beatmap: Beatmap) -> float:
    last_time = max(
        ho.end_time if isinstance(ho, HoldNote) else ho.time for ho in beatmap.hit_objects(stacking=False)
    )
    return get_median_mpb(beatmap.timing_points, _td_floor_seconds_ms(last_time))


def get_median_mpb(timing_points: list[TimingPoint], last_time: float) -> float:
    """osu!-stable's most-common-BPM computation (duration-weighted mode)."""
    this_beat_length = 0.0
    bpm_durations: dict[float, int] = {}

    for i in range(len(timing_points) - 1, -1, -1):
        tp = timing_points[i]
        offset = _td_floor_seconds_ms(tp.offset)

        if tp.parent is None:
            this_beat_length = tp.ms_per_beat

        if this_beat_length == 0 or offset > last_time or (tp.parent is not None and i > 0):
            continue

        duration = int(last_time - (0 if i == 0 else offset))
        bpm_durations[this_beat_length] = bpm_durations.get(this_beat_length, 0) + duration
        last_time = offset

    longest_time = 0
    median = 0.0
    for bpm, duration in bpm_durations.items():
        if duration > longest_time:
            longest_time = duration
            median = bpm
    return median
