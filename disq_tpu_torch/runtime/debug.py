"""Environment knobs."""

from __future__ import annotations

import os


def env_flag(name: str, default: str = "0") -> bool:
    """Boolean env-var semantics: unset ⇒ ``default``; "", 0, false and
    off ⇒ False; anything else ⇒ True."""
    return os.environ.get(name, default).lower() not in (
        "", "0", "false", "off")
