"""Config dataclass mixins: JSON round trip and command-line flags (copy of
``blurred_gan_tpu/utils/config.py``).

``JsonSerializable`` writes and reads the JSON sidecars; ``ParseableFromCommandLine``
generates one argparse flag per dataclass field (name, type, default), the
first class to claim a flag on a parser keeping it, so the nested
hyperparameter classes can share a parser.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


class JsonSerializable:
    """JSON round trip for config dataclasses."""

    def asdict(self) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if hasattr(v, "item"):  # numpy / torch scalar
                v = v.item()
            out[f.name] = v
        return out

    def save_json(self, file_path: str) -> None:
        with open(file_path, "w") as f:
            json.dump(self.asdict(), f, indent=1)

    @classmethod
    def from_json(cls, file_path: str):
        """The dataclass from a sidecar; keys it does not declare are ignored."""
        with open(file_path, "r") as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class ParseableFromCommandLine:
    """``add_arguments(parser)`` declares a flag per field; ``from_args(args)``
    builds the dataclass from the parsed namespace."""

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> None:
        group = parser.add_argument_group(cls.__qualname__)
        existing = {a.dest for a in parser._actions}
        for f in dataclasses.fields(cls):
            if not f.init or f.name in existing:
                continue  # first class to claim a flag wins (shared base fields)
            default = (
                f.default
                if f.default is not dataclasses.MISSING
                else (f.default_factory() if f.default_factory is not dataclasses.MISSING
                      else None)
            )
            ftype = f.type if isinstance(f.type, type) else _resolve_type(f.type)
            kwargs: Dict[str, Any] = {"dest": f.name, "default": default,
                                      "help": f"(default: {default})"}
            if ftype is bool:
                kwargs["type"] = _parse_bool
            elif ftype in (int, float, str):
                kwargs["type"] = ftype
            group.add_argument(f"--{f.name}", **kwargs)

    @classmethod
    def from_args(cls, args: argparse.Namespace):
        field_names = {f.name for f in dataclasses.fields(cls) if f.init}
        return cls(**{k: v for k, v in vars(args).items() if k in field_names})


def _resolve_type(annotation):
    """String annotations (``from __future__ import annotations``) to builtins."""
    mapping = {"int": int, "float": float, "str": str, "bool": bool}
    if isinstance(annotation, str):
        return mapping.get(annotation, str)
    return annotation if isinstance(annotation, type) else str
