from .events import EVENT_TYPES_WITH_NEW_COMBO, EventType, Group, merge_groups, speed_groups
from .osu import Beatmap, Circle, HoldNote, Slider, Spinner, TimingPoint
from .parser import BeatmapEventParser, get_song_length, load_beatmap

__all__ = [
    "Beatmap",
    "BeatmapEventParser",
    "Circle",
    "EventType",
    "EVENT_TYPES_WITH_NEW_COMBO",
    "Group",
    "HoldNote",
    "Slider",
    "Spinner",
    "TimingPoint",
    "get_song_length",
    "load_beatmap",
    "merge_groups",
    "speed_groups",
]
