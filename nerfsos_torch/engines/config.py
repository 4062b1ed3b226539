"""Config-file-aware argument parsing (a ``configargparse`` replacement).

Same behaviour as ``nerfsos_tpu/engines/config.py``: ``--config`` names a file
of ``key = value`` lines (the reference's ``configs/*.txt``) whose values
become defaults that command-line flags override.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Sequence


def parse_config_file(path: str) -> Dict[str, str]:
    """Parse ``key = value`` lines; '#' starts a comment; blank lines skipped."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"bad config line: {line!r}")
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse with configargparse-style ``--config`` support."""

    def _coerce(self, action: argparse.Action, raw: str) -> Any:
        if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
            return raw.lower() in ("true", "1", "yes")
        if action.nargs in ("+", "*") or isinstance(action.nargs, int):
            parts = raw.replace(",", " ").split()
            if raw.startswith("[") and raw.endswith("]"):
                parts = raw[1:-1].replace(",", " ").split()
            return [action.type(p) if action.type else p for p in parts]
        if action.type is not None:
            return action.type(raw)
        return raw

    def _apply_config(self, argv: Sequence[str]) -> None:
        if "--config" not in argv:
            return
        idx = list(argv).index("--config")
        if idx + 1 >= len(argv):
            return
        by_key: Dict[str, argparse.Action] = {}
        for action in self._actions:
            for opt in action.option_strings:
                by_key[opt.lstrip("-")] = action
        for action in self._actions:  # a dest wins over an option alias
            by_key[action.dest] = action
        defaults: Dict[str, Any] = {}
        for k, raw in parse_config_file(argv[idx + 1]).items():
            action = by_key.get(k)
            if action is None:
                print(f"[config] ignoring unknown key: {k}")
                continue
            defaults[action.dest] = self._coerce(action, raw)
            action.required = False  # a config-file value satisfies a required flag
        self.set_defaults(**defaults)

    def parse_known_args(self, args=None, namespace=None):
        argv = list(sys.argv[1:] if args is None else args)
        self._apply_config(argv)
        return super().parse_known_args(argv, namespace)
