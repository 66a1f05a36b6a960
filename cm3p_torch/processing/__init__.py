from .processor import (
    CM3PProcessor,
    get_difficulty,
    get_hitsounded_status,
    get_hold_note_ratio,
    get_metadata,
    get_scroll_speed_ratio,
)

__all__ = [
    "CM3PProcessor",
    "get_difficulty",
    "get_hitsounded_status",
    "get_hold_note_ratio",
    "get_metadata",
    "get_scroll_speed_ratio",
]
