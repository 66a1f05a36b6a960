"""Serialization mixin for processor components.

Provides the ``save_pretrained`` / ``from_pretrained`` directory contract the
reference inherits from HF mixins (``processing_cm3p.py:659-762``), without
the transformers dependency: each component writes one JSON config (and
optionally a vocab.json) to its folder.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Union

PathLike = Union[str, os.PathLike]


def write_json(path: PathLike, data: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False, indent=2, sort_keys=False)


def read_json(path: PathLike) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


class JsonConfigMixin:
    """Save/restore a component from ``<dir>/<config_name>``.

    Subclasses define ``config_name`` and ``get_config() -> dict``; the
    config dict must round-trip through ``cls(**config)``.
    """

    config_name: str = "config.json"
    # fallback filenames read by from_pretrained — lets every component load
    # the HF/AutoProcessor layout (interop.export_hf_processor and the
    # reference's save_pretrained) where e.g. the parser config is named
    # preprocessor_config.json; unknown keys in those files (auto_map,
    # tokenizer_class, added_tokens_decoder, ...) are dropped by the
    # constructor-signature filter below
    config_aliases: tuple = ()

    def get_config(self) -> dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError

    def save_pretrained(self, save_directory: PathLike) -> list[str]:
        save_directory = Path(save_directory)
        save_directory.mkdir(parents=True, exist_ok=True)
        config = dict(self.get_config())
        config["component_class"] = type(self).__name__
        out = save_directory / self.config_name
        write_json(out, config)
        extra = self._save_extra(save_directory)
        return [str(out), *extra]

    def _save_extra(self, save_directory: Path) -> list[str]:
        return []

    @classmethod
    def from_pretrained(cls, directory: PathLike, **overrides):
        import inspect

        directory = Path(directory)
        for name in (cls.config_name, *cls.config_aliases):
            if (directory / name).exists():
                config = read_json(directory / name)
                break
        else:
            raise FileNotFoundError(
                f"no {cls.config_name} (or {cls.config_aliases}) in {directory}"
            )
        config.pop("component_class", None)
        config = cls._load_extra(directory, config)
        config.update(overrides)
        # drop keys the constructor doesn't take (HF-layout extras like
        # auto_map / tokenizer_class / added_tokens_decoder / processor_class)
        # — but ONLY for alias (HF-layout) files; a native config.json with
        # an unknown key means checkpoint/code drift and must raise, not
        # silently lose the saved value
        if name != cls.config_name:
            params = inspect.signature(cls.__init__).parameters
            if not any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
                config = {k: v for k, v in config.items() if k in params}
        return cls(**config)

    @classmethod
    def _load_extra(cls, directory: Path, config: dict) -> dict:
        return config
