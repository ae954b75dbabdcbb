"""The GPU's name and power limit, for labelling device measurements."""

from __future__ import annotations

import subprocess
from typing import Optional


def card_line() -> Optional[str]:
    """``name, power limit`` of the first GPU, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    it, or None where nvidia-smi is missing or fails.  A card set below its
    maximum power runs slower under load, so every device number is kept
    beside this line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None
