"""Generic CLI argument parser (behavioral port of RayZath/args.{hpp,cpp}).

Arguments are declared with variant names (e.g. {"-h", "--help"}), a
description, and a list of options, each required/optional and single/multiple.
``parse`` maps each present argument variant to its collected option values;
unknown arguments and duplicate arguments raise, a missing required option
raises; optional options stop collecting at the next recognized argument.
A copy of ``rayzath_tpu/utils/args.py``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence


class Option:
    def __init__(self, name: str, required: bool = True, multiple: bool = False):
        self.name = name
        self.required = required
        self.multiple = multiple

    def __str__(self) -> str:
        s = self.name + ("..." if self.multiple else "")
        return s if self.required else f"[{s}]"


class Arg:
    def __init__(self, variants, description: str, options: Sequence[Option] = ()):
        self.variants = set(variants)
        if not self.variants:
            raise ValueError("argument had 0 variants")
        self.description = description
        self.options = list(options)

    def __str__(self) -> str:
        head = ", ".join(sorted(self.variants))
        opts = " ".join(str(o) for o in self.options)
        return f"{head} {opts}".strip()

    def has_variant(self, v: str) -> bool:
        return v in self.variants


class Args:
    def __init__(self):
        self._args: List[Arg] = []

    def arg(self, a: Arg) -> "Args":
        self._args.append(a)
        return self

    def _find(self, s: str):
        for a in self._args:
            if a.has_variant(s):
                return a
        return None

    def usage_string(self) -> str:
        strs = [str(a) for a in self._args]
        width = max((len(s) for s in strs), default=0)
        lines = ["Arguments:"]
        for s, a in zip(strs, self._args):
            lines.append(f"  {s:<{width}} {a.description}")
        return "\n".join(lines) + "\n"

    def parse(self, argv: Sequence[str]) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        i = 0
        n = len(argv)
        while i < n:
            arg = self._find(argv[i])
            if arg is None:
                raise RuntimeError(f'Unknown argument "{argv[i]}".')
            key = argv[i]
            if key in out:
                raise RuntimeError(f'"{key}" argument passed more than once.')
            out[key] = []
            i += 1
            for option in arg.options:
                if option.required:
                    if i >= n:
                        raise RuntimeError(
                            f'Option "{option.name}" required for argument '
                            f'"{sorted(arg.variants)[0]}".')
                    out[key].append(argv[i]); i += 1
                    while option.multiple and i < n:
                        out[key].append(argv[i]); i += 1
                else:
                    if i >= n:
                        break
                    while i < n and self._find(argv[i]) is None:
                        out[key].append(argv[i]); i += 1
                        if not option.multiple:
                            break
                    if i < n and self._find(argv[i]) is not None:
                        break
        return out
