"""PETSc-options-style configuration.

Counterpart of ``pacmensl_tpu/sys/options.py`` (the reference reads its
runtime flags from the PETSc options database: ``-fsp_partitioning_type``,
``-fsp_verbosity``, ``-fsp_log_events``, ``-ts_type``;
``src/Fsp/FspSolverMultiSinks.cpp:523-574``): a key -> string store filled
from ``sys.argv``-style token lists and from environment variables, with
typed getters.  Pure Python; the port keeps its own copy.

Example::

    opts = Options.from_argv(["-fsp_verbosity", "2", "-fsp_log_events"])
    opts.get_int("fsp_verbosity", 0)   # -> 2
    opts.get_bool("fsp_log_events")    # -> True
"""
from __future__ import annotations

import os
import sys as _sys
from typing import Dict, Optional


class Options:
    def __init__(self, table: Optional[Dict[str, str]] = None):
        self._table: Dict[str, str] = dict(table or {})

    # ------------------------------------------------------------ loading
    @classmethod
    def from_argv(cls, argv=None) -> "Options":
        """Parse ``-key value`` and bare ``-flag`` tokens (PETSc style):
        a token that starts with ``-`` and is not a number is a key; the
        next token is its value unless it is a key too (a bare flag reads
        ``"1"``).  Other tokens are skipped."""
        if argv is None:
            argv = _sys.argv[1:]
        table: Dict[str, str] = {}
        i = 0
        while i < len(argv):
            tok = argv[i]
            if _is_key(tok):
                if i + 1 < len(argv) and not _is_key(argv[i + 1]):
                    table[tok.lstrip("-")] = argv[i + 1]
                    i += 2
                else:
                    table[tok.lstrip("-")] = "1"
                    i += 1
            else:
                i += 1
        return cls(table)

    @classmethod
    def from_env(cls, prefix: str = "PACMENSL_OPT_") -> "Options":
        """Options from the environment variables ``<prefix><KEY>``, keys
        in lower case."""
        return cls({k[len(prefix):].lower(): v
                    for k, v in os.environ.items() if k.startswith(prefix)})

    def update(self, other: "Options") -> "Options":
        self._table.update(other._table)
        return self

    def set(self, key: str, value) -> None:
        self._table[key.lstrip("-")] = str(value)

    # ------------------------------------------------------------ getters
    def has(self, key: str) -> bool:
        return key.lstrip("-") in self._table

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._table.get(key.lstrip("-"), default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key)
        return default if v is None else int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key)
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v is None:
            return default
        return v.lower() not in ("0", "false", "no", "off")

    def as_dict(self) -> Dict[str, str]:
        return dict(self._table)

    def __repr__(self):
        return f"Options({self._table!r})"


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _is_key(tok: str) -> bool:
    return tok.startswith("-") and not _is_number(tok)


#: the default options, read from the environment at import
GLOBAL_OPTIONS = Options.from_env()
