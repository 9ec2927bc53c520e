"""Scene IO: JSON scene schema, OBJ/MTL, bitmaps (reference L4 loader/saver
stack, RayZath/{loader,saver,json_loader,json_saver}).

Counterpart of ``rayzath_tpu/io``: jax-free copies of its modules that
build the port's ``models`` and use the port's ``utils/hostmath.py`` and
``native/`` OBJ parser, so a file loads into the same world in both
packages. ``.hdr`` and ``.npy`` maps decode in NumPy; PNG and JPEG maps
need PIL and raise without it.
"""
from .load_result import LoadResult
from .loader import load_scene, save_scene
from .bitmap import load_image, save_image, save_depth

__all__ = ["LoadResult", "load_scene", "save_scene",
           "load_image", "save_image", "save_depth"]
