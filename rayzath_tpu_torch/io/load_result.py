"""Loader message/warning/error log (reference LoadResult, loader.hpp:136-192)."""
from __future__ import annotations


class LoadResult:
    def __init__(self):
        self.messages: list[str] = []
        self.warnings: list[str] = []
        self.errors: list[str] = []

    def log_message(self, text: str) -> None:
        self.messages.append(text)

    def log_warning(self, text: str) -> None:
        self.warnings.append(text)

    def log_error(self, text: str) -> None:
        self.errors.append(text)

    @property
    def ok(self) -> bool:
        return not self.errors

    def __str__(self) -> str:
        out = []
        out += [f"[message] {m}" for m in self.messages]
        out += [f"[warning] {w}" for w in self.warnings]
        out += [f"[error] {e}" for e in self.errors]
        return "\n".join(out)
