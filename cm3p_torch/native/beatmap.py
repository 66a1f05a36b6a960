"""ctypes layer of the native .osu -> events -> token-ids front end (``beatmap_fast.cpp``).

The Python implementation in ``cm3p_torch/beatmap`` + ``cm3p_torch/tokenize`` stays
the source of truth: the vocab-id lookup tables are built here from the Python
tokenizer's vocab (the C++ side never constructs token strings), and every input
the native side does not cover comes back as an error the processor answers by
taking the Python path.

Parity: ``tests/test_torch_native.py`` asserts bit-identical window ids against the
JAX package's Python and native paths on every fixture x parser config x speed.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import library

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


class NativeDeclined(RuntimeError):
    """The C++ side does not cover this beatmap (the processor takes the Python path)."""


class CtSummary(ctypes.Structure):
    _fields_ = [
        ("mode", ctypes.c_int32),
        ("n_hit_objects", ctypes.c_int32),
        ("hitsounded", ctypes.c_int32),
        ("parse_error", ctypes.c_int32),
        ("circle_size", ctypes.c_double),
        ("slider_multiplier", ctypes.c_double),
        ("hold_note_ratio", ctypes.c_double),
        ("scroll_speed_ratio", ctypes.c_double),
        ("last_ho_for_length", ctypes.c_double),
        ("last_tp_offset", ctypes.c_double),
    ]


class CtParserConfig(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int32) for name in (
        "add_timing", "add_snapping", "add_timing_points", "add_hitsounds",
        "add_distances", "add_positions", "add_kiai", "add_sv", "add_mania_sv",
        "mania_bpm_normalized_scroll_speed", "slider_version",
        "emit_mania_column",
    )]


class CtTokTables(ctypes.Structure):
    _fields_ = [
        ("cls_id", ctypes.c_int32),
        ("bos_id", ctypes.c_int32),
        ("eos_id", ctypes.c_int32),
        ("audio_bos_id", ctypes.c_int32),
        ("audio_id", ctypes.c_int32),
        ("audio_eos_id", ctypes.c_int32),
        ("nc_id", ctypes.c_int32),
        ("event_ids", _i32p),
        ("event_nc_ids", _i32p),
        ("ts_qmin", ctypes.c_int64),
        ("ts_qmax", ctypes.c_int64),
        ("ts_min", ctypes.c_double),
        ("ts_max", ctypes.c_double),
        ("ts_step", ctypes.c_double),
        ("ts", _i32p),
        ("snap", _i32p),
        ("dist_qmax", ctypes.c_int64),
        ("dist_max", ctypes.c_double),
        ("dist_step", ctypes.c_double),
        ("dist", _i32p),
        ("pos_split", ctypes.c_int32),
        ("pos_x_min", ctypes.c_double),
        ("pos_x_max", ctypes.c_double),
        ("pos_y_min", ctypes.c_double),
        ("pos_y_max", ctypes.c_double),
        ("pos_step", ctypes.c_double),
        ("pos_qx_min", ctypes.c_int64),
        ("pos_qx_max", ctypes.c_int64),
        ("pos_qy_min", ctypes.c_int64),
        ("pos_qy_max", ctypes.c_int64),
        ("pos_x", _i32p),
        ("pos_y", _i32p),
        ("pos_xy", _i32p),
        ("mania", _i32p),
        ("ss", _i32p),
        ("hs", _i32p),
        ("vol", _i32p),
    ]


SIGNATURES = {  # entry point -> (argtypes, restype)
    "ct_beatmap_parse": ([ctypes.c_char_p, ctypes.c_int64], ctypes.c_void_p),
    "ct_beatmap_free": ([ctypes.c_void_p], None),
    "ct_beatmap_summary": ([ctypes.c_void_p, ctypes.POINTER(CtSummary)], None),
    "ct_parse_events": (
        [ctypes.c_void_p, ctypes.POINTER(CtParserConfig), ctypes.c_double, ctypes.c_double], ctypes.c_void_p
    ),
    "ct_events_free": ([ctypes.c_void_p], None),
    "ct_events_count": ([ctypes.c_void_p], ctypes.c_int64),
    "ct_events_hs_count": ([ctypes.c_void_p], ctypes.c_int64),
    "ct_events_last_time": ([ctypes.c_void_p], ctypes.c_int64),
    "ct_events_export": (
        [ctypes.c_void_p, _i32p, _i64p, _u8p, _i32p, _i32p, _i32p, _i32p, _i32p, _u8p, _u8p, _f64p, _i32p,
         _i32p, _i32p, _i32p, _i32p, _i32p],
        None,
    ),
    "ct_tokenize_windows": (
        [ctypes.c_void_p, ctypes.POINTER(CtTokTables), _f64p, _f64p, _f64p, ctypes.c_int64, _i32p,
         ctypes.c_int32, ctypes.c_int32, _i32p, _i32p, _i32p],
        ctypes.c_int32,
    ),
}


_INT_NONE = np.int32(np.iinfo(np.int32).min)


def parser_config_struct(parser) -> CtParserConfig:
    """CtParserConfig from a :class:`BeatmapEventParser`."""
    return CtParserConfig(
        int(parser.add_timing), int(parser.add_snapping),
        int(parser.add_timing_points), int(parser.add_hitsounds),
        int(parser.add_distances), int(parser.add_positions),
        int(parser.add_kiai), int(parser.add_sv), int(parser.add_mania_sv),
        int(parser.mania_bpm_normalized_scroll_speed),
        int(parser.slider_version), int(parser.emit_mania_column),
    )


class TokTables:
    """Dense vocab-id lookup tables for the native tokenizer.

    Built once per tokenizer from its Python vocab; every table entry is the
    exact id ``encode_groups`` would emit for that quantized value (including
    [UNK] for values whose formatted token string is out of vocab), so the
    C++ side only does clamp + round + index.
    """

    def __init__(self, tok):
        from ..beatmap.events import EventType

        vocab = tok._full_vocab
        unk = tok._unk_id
        get = vocab.get

        def arr(values):
            a = np.asarray(values, dtype=np.int32)
            return np.ascontiguousarray(a)

        self._event_ids = arr([tok._event_ids[et] for et in EventType])
        self._event_nc_ids = arr([
            get(f"[{et.value.upper()}_NEW_COMBO]", unk) for et in EventType
        ])
        # time shift: qi = round(clamped / step), python banker's rounding
        step = tok.time_step
        qmin = round(tok.min_time / step)
        qmax = round(tok.max_time / step)
        self._ts = arr([get(f"[TIME_SHIFT_{int(qi * step)}]", unk)
                        for qi in range(qmin, qmax + 1)])
        self._snap = arr([tok._snap_ids[s] for s in range(17)])
        dstep = tok.distance_step
        dqmax = round(tok.max_distance / dstep)
        self._dist = arr([get(f"[DISTANCE_{int(qi * dstep)}]", unk)
                          for qi in range(dqmax + 1)])
        pstep = tok.position_step
        r = tok.position_range
        qx_min, qx_max = round(r[0] / pstep), round(r[1] / pstep)
        qy_min, qy_max = round(r[2] / pstep), round(r[3] / pstep)
        if tok.position_split_axes:
            self._pos_x = arr([get(f"[POS_X_{int(q * pstep)}]", unk)
                               for q in range(qx_min, qx_max + 1)])
            self._pos_y = arr([get(f"[POS_Y_{int(q * pstep)}]", unk)
                               for q in range(qy_min, qy_max + 1)])
            self._pos_xy = arr([unk])
        else:
            self._pos_x = arr([unk])
            self._pos_y = arr([unk])
            self._pos_xy = arr([
                get(f"[POS_{int(qx * pstep)}_{int(qy * pstep)}]", unk)
                for qx in range(qx_min, qx_max + 1)
                for qy in range(qy_min, qy_max + 1)
            ])
        self._mania = arr([get(f"[MANIA_COLUMN_{c}]", unk) for c in range(1, 19)])
        self._ss = arr([get(f"[SCROLL_SPEED_{k * 0.01:.2f}]", unk)
                        for k in range(1001)])
        self._hs = arr([get(f"[HITSOUND_{h << 1}_{s}_{a}]", unk)
                        for h in range(8) for s in range(1, 4) for a in range(1, 4)])
        self._vol = arr([tok._vol_ids[v] for v in range(101)])

        def p(a):
            return a.ctypes.data_as(_i32p)

        self.struct = CtTokTables(
            cls_id=vocab[tok.cls_token] if tok.add_cls_token else -1,
            bos_id=vocab[tok.bos_token],
            eos_id=vocab[tok.eos_token],
            audio_bos_id=vocab[tok.audio_bos_token],
            audio_id=vocab[tok.audio_token],
            audio_eos_id=vocab[tok.audio_eos_token],
            nc_id=get("[NEW_COMBO]", unk) if tok.separate_new_combo_token else -1,
            event_ids=p(self._event_ids),
            event_nc_ids=p(self._event_nc_ids),
            ts_qmin=qmin, ts_qmax=qmax,
            ts_min=float(tok.min_time), ts_max=float(tok.max_time),
            ts_step=float(step),
            ts=p(self._ts),
            snap=p(self._snap),
            dist_qmax=dqmax,
            dist_max=float(tok.max_distance), dist_step=float(dstep),
            dist=p(self._dist),
            pos_split=int(tok.position_split_axes),
            pos_x_min=float(r[0]), pos_x_max=float(r[1]),
            pos_y_min=float(r[2]), pos_y_max=float(r[3]),
            pos_step=float(pstep),
            pos_qx_min=qx_min, pos_qx_max=qx_max,
            pos_qy_min=qy_min, pos_qy_max=qy_max,
            pos_x=p(self._pos_x), pos_y=p(self._pos_y), pos_xy=p(self._pos_xy),
            mania=p(self._mania), ss=p(self._ss), hs=p(self._hs),
            vol=p(self._vol),
        )


class NativeBeatmap:
    """Owns the parsed-beatmap handle; mirrors load_beatmap + parse_beatmap."""

    def __init__(self, text: bytes):
        lib = library()
        self._lib = lib
        self._h = lib.ct_beatmap_parse(text, len(text))
        if not self._h:
            raise NativeDeclined("ct_beatmap_parse failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ct_beatmap_free(self._h)
            self._h = None

    @classmethod
    def from_path(cls, path) -> "NativeBeatmap":
        # same decode semantics as osu.py:from_path
        with open(path, "r", encoding="utf-8-sig", errors="replace") as f:
            return cls(f.read().encode("utf-8"))

    def summary(self) -> CtSummary:
        s = CtSummary()
        self._lib.ct_beatmap_summary(self._h, ctypes.byref(s))
        return s

    def parse_events(self, parser, speed: float, song_length: float) -> "NativeEvents":
        cfg = parser_config_struct(parser)
        h = self._lib.ct_parse_events(self._h, ctypes.byref(cfg),
                                      ctypes.c_double(speed),
                                      ctypes.c_double(song_length))
        if not h:
            raise NativeDeclined("ct_parse_events failed")
        ev = NativeEvents(self._lib, h)
        if ev.count < 0:
            raise NativeDeclined("native event lowering hit a python-raise path")
        return ev


class NativeEvents:
    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle
        self.count = int(lib.ct_events_count(handle))

    def last_time(self) -> Optional[int]:
        t = int(self._lib.ct_events_last_time(self._h))
        return None if t == -(2**63) else t

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ct_events_free(self._h)
            self._h = None

    def export_arrays(self) -> dict:
        n = max(self.count, 0)
        n_hs = int(self._lib.ct_events_hs_count(self._h))
        out = {
            "event_type": np.empty(n, np.int32),
            "time": np.empty(n, np.int64),
            "has_time": np.empty(n, np.uint8),
            "snapping": np.empty(n, np.int32),
            "distance": np.empty(n, np.int32),
            "x": np.empty(n, np.int32),
            "y": np.empty(n, np.int32),
            "mania_column": np.empty(n, np.int32),
            "new_combo": np.empty(n, np.uint8),
            "has_ss": np.empty(n, np.uint8),
            "scroll_speed": np.empty(n, np.float64),
            "hs_off": np.empty(n, np.int32),
            "hs_cnt": np.empty(n, np.int32),
            "hs": np.empty(n_hs, np.int32),
            "ss": np.empty(n_hs, np.int32),
            "as": np.empty(n_hs, np.int32),
            "vol": np.empty(n_hs, np.int32),
        }
        self._lib.ct_events_export(
            self._h,
            out["event_type"].ctypes.data_as(_i32p),
            out["time"].ctypes.data_as(_i64p),
            out["has_time"].ctypes.data_as(_u8p),
            out["snapping"].ctypes.data_as(_i32p),
            out["distance"].ctypes.data_as(_i32p),
            out["x"].ctypes.data_as(_i32p),
            out["y"].ctypes.data_as(_i32p),
            out["mania_column"].ctypes.data_as(_i32p),
            out["new_combo"].ctypes.data_as(_u8p),
            out["has_ss"].ctypes.data_as(_u8p),
            out["scroll_speed"].ctypes.data_as(_f64p),
            out["hs_off"].ctypes.data_as(_i32p),
            out["hs_cnt"].ctypes.data_as(_i32p),
            out["hs"].ctypes.data_as(_i32p),
            out["ss"].ctypes.data_as(_i32p),
            out["as"].ctypes.data_as(_i32p),
            out["vol"].ctypes.data_as(_i32p),
        )
        return out

    def to_groups(self) -> list:
        """Python Group objects (for parity tests / interop)."""
        from ..beatmap.events import EventType, Group

        a = self.export_arrays()
        ets = list(EventType)
        imin = np.iinfo(np.int32).min
        groups = []
        for i in range(self.count):
            snap = int(a["snapping"][i])
            off, cnt = int(a["hs_off"][i]), int(a["hs_cnt"][i])
            groups.append(Group(
                event_type=ets[int(a["event_type"][i])],
                time=int(a["time"][i]),
                has_time=bool(a["has_time"][i]),
                snapping=None if snap < 0 else snap,
                distance=None if a["distance"][i] == imin else int(a["distance"][i]),
                x=None if a["x"][i] == imin else int(a["x"][i]),
                y=None if a["y"][i] == imin else int(a["y"][i]),
                mania_column=None if a["mania_column"][i] == imin else int(a["mania_column"][i]),
                new_combo=bool(a["new_combo"][i]),
                hitsounds=[int(v) for v in a["hs"][off:off + cnt]],
                samplesets=[int(v) for v in a["ss"][off:off + cnt]],
                additions=[int(v) for v in a["as"][off:off + cnt]],
                volumes=[int(v) for v in a["vol"][off:off + cnt]],
                scroll_speed=float(a["scroll_speed"][i]) if a["has_ss"][i] else None,
            ))
        return groups

    def tokenize_windows(
        self,
        tables: TokTables,
        start_ms: np.ndarray,
        end_ms: np.ndarray,
        next_start_ms: np.ndarray,
        num_audio_tokens: Optional[np.ndarray],
        max_length: int,
        target_len: int,
        pad_id: int,
    ):
        """(n_windows, target_len) ids+mask, or None on a python-raise path."""
        n = len(start_ms)
        ids = np.full((n, target_len), pad_id, np.int32)
        mask = np.zeros((n, target_len), np.int32)
        lens = np.zeros(n, np.int32)
        start = np.ascontiguousarray(start_ms, np.float64)
        end = np.ascontiguousarray(end_ms, np.float64)
        nxt = np.ascontiguousarray(next_start_ms, np.float64)
        nat = (np.ascontiguousarray(num_audio_tokens, np.int32)
               if num_audio_tokens is not None else None)
        rc = self._lib.ct_tokenize_windows(
            self._h, ctypes.byref(tables.struct),
            start.ctypes.data_as(_f64p), end.ctypes.data_as(_f64p),
            nxt.ctypes.data_as(_f64p), n,
            nat.ctypes.data_as(_i32p) if nat is not None else None,
            max_length, target_len,
            ids.ctypes.data_as(_i32p), mask.ctypes.data_as(_i32p),
            lens.ctypes.data_as(_i32p),
        )
        if rc != 0:
            return None
        return ids, mask, lens
