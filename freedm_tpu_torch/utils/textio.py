"""Small text-input helpers shared by the config parsers.

The port's own copy of ``freedm_tpu/utils/textio.py``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Union


def read_source(source: Union[str, Path], marker: str) -> str:
    """Accept a filesystem path or raw config text; return the text.

    Disambiguation order: a :class:`~pathlib.Path` is always a path; a
    string naming an existing file is a path; anything else is raw text
    of the target format.  ``marker`` (a substring characteristic of the
    format, e.g. ``"<"`` for XML) is only a fallback check: a marker-free
    non-existent string that also looks like a pathname (single token, no
    newline) raises ``FileNotFoundError`` rather than being misparsed as
    config text.
    """
    if isinstance(source, Path):
        return source.read_text()
    text = str(source)
    if os.path.exists(text):
        return Path(text).read_text()
    # Nonexistent but path-shaped — a single line without the format
    # marker that is one token or contains a path separator — is a
    # typo'd path, not config text.
    pathlike = (
        "\n" not in text
        and marker not in text
        and (" " not in text or "/" in text or "\\" in text)
    )
    if pathlike:
        raise FileNotFoundError(f"config source not found: {text!r}")
    return text
