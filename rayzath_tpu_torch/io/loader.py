"""Loader/Saver facade (reference Loader::loadScene, loader.cpp:1041-1056 and
Saver::saveScene, saver.cpp; SaveOptions per saver.hpp:104-111; cross-load
asset dedup per LoadedSet, loader.hpp:16-134)."""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from .json_scene import JsonLoader, JsonSaver
from .load_result import LoadResult


class LoadedSet:
    """Cross-load asset registry (reference ``LoadedSet``,
    loader.hpp:16-134): maps and materials loaded from files are remembered
    by (kind, absolute path), so loading several scenes into one World
    reuses the same objects instead of duplicating them. Lives on the World
    (created lazily) and survives across loads."""

    def __init__(self):
        self.by_path: dict = {}

    def get(self, kind: str, path: str):
        return self.by_path.get((kind, os.path.abspath(path)))

    def add(self, kind: str, path: str, obj) -> None:
        self.by_path[(kind, os.path.abspath(path))] = obj


def loaded_set(world) -> LoadedSet:
    ls = getattr(world, "_loaded_set", None)
    if ls is None:
        ls = LoadedSet()
        object.__setattr__(world, "_loaded_set", ls)
    return ls


#: Object-group keys accepted by :class:`SaveOptions.only`.
SAVE_GROUPS = frozenset({"maps", "materials", "meshes", "cameras", "lights",
                         "instances", "groups"})


@dataclass(frozen=True)
class SaveOptions:
    """Scene-save options (reference Saver::SaveOptions, saver.hpp:104-111).

    ``allow_partial_write``: when False a failed save removes everything it
    wrote (the reference's inverse flag keeps partial content).
    ``duplicate_textures``: when False (default) map files are named by
    content hash and identical maps share one file which is never
    rewritten; True restores one-file-per-container-slot naming.
    ``only``: subset of SAVE_GROUPS to save (selective save — the
    reference's per-type save modals); None saves everything.
    """
    allow_partial_write: bool = True
    duplicate_textures: bool = False
    only: Optional[frozenset] = None

    def __post_init__(self):
        if self.only is not None:
            bad = set(self.only) - SAVE_GROUPS
            if bad:
                raise ValueError(f"unknown save groups: {sorted(bad)}")


def load_scene(world, path: str) -> LoadResult:
    """Load a scene file into the world; dispatches on extension (.json only,
    like the reference)."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".json":
        raise ValueError(f"unsupported scene extension {ext!r} (expected .json)")
    result = JsonLoader(world, path).load()
    world.touch()
    return result


def load_hdr(world, path: str, name: str | None = None, **map_kwargs):
    """Load an HDR image as a (Texture, EmissionMap) pair in the world —
    the reference BitmapLoader::loadHDR semantics (loader.cpp:103-138):
    texture holds the chroma (rgb / max component), the emission map the
    max component, so `texture * emission` reconstructs the radiance.
    Attach both to a material (e.g. ``world.material`` for an environment
    sky). ``map_kwargs`` (filter_mode, address_mode, scale, ...) apply to
    both maps. Returns (texture, emission_map)."""
    from ..models.texture import Texture, EmissionMap
    from .bitmap import load_hdr as _load, hdr_to_texture_emission

    rgb = _load(path)
    tex_data, emi_data = hdr_to_texture_emission(rgb)
    base = name or os.path.splitext(os.path.basename(path))[0]
    tex = Texture(name=base, data=tex_data, **map_kwargs)
    emi = EmissionMap(name=f"{base} emission", data=emi_data, **map_kwargs)
    world.textures.create(tex)
    world.emission_maps.create(emi)
    world.touch()
    return tex, emi


def save_scene(world, path: str,
               options: Optional[SaveOptions] = None) -> None:
    """Save the world as a .json scene (+ PNG maps beside it)."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".json":
        raise ValueError(f"unsupported scene extension {ext!r} (expected .json)")
    JsonSaver(world, path).save(options or SaveOptions())
