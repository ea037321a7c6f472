"""Atomic JSON checkpoint files.

Port of ``save`` and ``load`` from ``freedm_tpu/runtime/checkpoint.py``
(:222, :231): one JSON file, written to ``<path>.tmp`` and renamed over
``path``, so a process killed mid-write leaves the previous checkpoint
intact.  The QSTS engine writes its chunk-boundary state through these.
The broker's ``collect_state``/``restore_state`` are not ported
(ROADMAP.md, module queue item 14).
"""

from __future__ import annotations

import json
import os
from typing import Dict


def save(path: str, state: Dict) -> None:
    """Atomic write: a kill mid-save must not corrupt the previous
    checkpoint."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)


def load(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)
