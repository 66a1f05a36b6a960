"""Hub ids resolved from a local Hugging Face cache: the counterpart of the JAX package's ``interop/hub.py``.

The reference loads models by repo id (``CM3PModel.from_pretrained("OliBomby/CM3P")``). The port's entry
points accept the same: a string that is not an existing path and looks like ``org/name`` resolves to a
snapshot directory of the local cache, which :func:`cm3p_torch.inference.load_pretrained` and
``CM3PProcessor.from_pretrained`` read as any local directory. Nothing is downloaded, and
``huggingface_hub`` is not needed: the cache's layout is walked here,

    <cache_dir>/models--<org>--<name>/refs/<revision>    the commit the revision points at
    <cache_dir>/models--<org>--<name>/snapshots/<commit>/  the files of that commit

``cache_dir`` defaults to ``~/.cache/huggingface/hub``; the port reads no environment variable, so a cache
elsewhere (the Hub's ``HF_HUB_CACHE``) is passed as ``cache_dir``.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional, Union

_REPO_ID = re.compile(r"^[\w.\-]+/[\w.\-]+$")


def looks_like_repo_id(name_or_path: Union[str, os.PathLike]) -> bool:
    s = str(name_or_path)
    return not Path(s).exists() and bool(_REPO_ID.match(s))


def resolve_artifact(
    name_or_path: Union[str, os.PathLike],
    revision: Optional[str] = None,
    cache_dir: Optional[Union[str, os.PathLike]] = None,
) -> str:
    """A local directory for ``name_or_path``.

    Local paths pass through untouched. A repo id resolves to ``snapshots/<commit>`` of the cache, the commit
    read from ``refs/<revision>`` (default ``main``) or given as ``revision`` itself. An id that the cache
    cannot resolve raises ``FileNotFoundError``.
    """
    if not looks_like_repo_id(name_or_path):
        return str(name_or_path)
    cache = Path(cache_dir) if cache_dir is not None else Path.home() / ".cache" / "huggingface" / "hub"
    repo = cache / ("models--" + str(name_or_path).replace("/", "--"))
    rev = revision or "main"
    ref = repo / "refs" / rev
    commit = ref.read_text().strip() if ref.is_file() else rev
    snapshot = repo / "snapshots" / commit
    if not snapshot.is_dir():
        raise FileNotFoundError(
            f"could not resolve {str(name_or_path)!r} as a local path or a Hub repo id in the cache {cache} at "
            f"revision {rev!r}: the port downloads nothing; fetch the repository into that cache, or pass "
            "cache_dir, or a local directory"
        )
    return str(snapshot)
