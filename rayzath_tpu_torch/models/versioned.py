"""Dirty tracking for host scene objects.

TPU-native analog of the reference ``Updatable``/``StateRegister`` dirty-bit
system (RayZath/updatable.hpp:10-54): instead of propagating dirty bits up an
object graph, every host object carries a monotonically increasing ``version``,
and ``World.content_version()`` folds all of them into one scene fingerprint
that the device compiler compares against to decide when to re-flatten.

Any assignment to a public attribute bumps the version; in-place ndarray edits
must call ``touch()`` explicitly (same contract as the reference's
``stateRegister().MakeModified()``).
"""
from __future__ import annotations


class Versioned:
    """Mixin: public attribute assignment bumps ``self.version``."""

    def __setattr__(self, name: str, value) -> None:
        object.__setattr__(self, name, value)
        if name != "version" and not name.startswith("_"):
            object.__setattr__(self, "version", self.__dict__.get("version", 0) + 1)

    def touch(self) -> None:
        object.__setattr__(self, "version", self.__dict__.get("version", 0) + 1)
