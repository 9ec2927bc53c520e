"""Build and load the hand-written CUDA kernels (``rayzath_tpu_torch/csrc``).

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into one shared library with a plain C interface
(no PyTorch headers, so the build takes seconds), loaded with
``ctypes``. The library lands in ``rayzath_tpu_torch/build/rz_kernels/``,
inside the package in a checkout and in an installed copy alike (git ignores
it), named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing is built at import time:
:func:`load` runs on the first kernel launch.

Flags: ``-O3`` for ``sm_90a``, IEEE division and square root, no fast math,
and ``-fmad=false`` so that every multiply and add rounds on its own, as the
plain PyTorch versions do; the kernels then return the plain versions' hits
bit for bit wherever their culling lets a ray reach its triangle.

This module is also the one seam of the kernel wrappers (``ops/``): each
wrapper is registered with :func:`counted`, checks its tensors with
:func:`card` and :func:`check` after :func:`load`, and launches through
:func:`launch`, which counts the launch against it. The registry
(:data:`COUNTED`) is what ``engine/cycle.py`` ``capture`` reads to keep the
counters true under graph replay, so a new wrapper needs no edit there.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "build" / "rz_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", *ARCH, "-fmad=false", "-prec-div=true",
              "-prec-sqrt=true", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_SIGNATURES = {
    # origin, direction, near, far, box_tab, frames, group table (null: the
    # flat walk), n_rays, cp, gp, t, id, visits (null: not counted), per
    # block groups entered (null: not counted), work (int64[3]: cluster
    # tests, triangle tests, slab tests; null: not counted), stream
    "rz_cluster_closest": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                           _P, _P, _P, _P],
    # origin, direction, dist, box_tab, frames, op_tab, group table (null:
    # the flat walk), n_rays, cp, gp, rgb, a, visits (null: not counted),
    # per block groups entered (null: not counted), work (as B1's), the
    # cutout tables slot_map and slot_uv (null: no cutouts), the fetch
    # count (int64[1]; null: not counted), the colour atlas, its block
    # table, the map rects, flags and uv transforms, maps, atlas width,
    # atlas texels, stream
    "rz_cluster_shadow": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                          _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                          _I, _I, _P],
    # origin, direction, near, far, ti_rows, cl_obox, frames, n_rays, ip,
    # t, id, inst, visits (null: not counted), work (int64[2]: instance
    # visits, cluster tests; null: not counted), stream
    "rz_cluster_closest_inst": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                                _P, _P, _P, _P],
    # origin, direction, dist, ti_rows, cl_obox, frames, cl_slot, op_tab,
    # n_rays, ip, rgb, a, visits (null: not counted), work (as B3's), stream
    "rz_cluster_shadow_inst": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                               _P, _P, _P, _P],
    # origin, direction, dist, g_rgb, g_a, box_tab, frames, op_tab, n_rays,
    # cp, d_op, visits (null: not counted), stream
    "rz_cluster_shadow_grad": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                               _P, _P],
    # origin, direction, dist, g_rgb, g_a, ti_rows, cl_obox, frames,
    # cl_slot, op_tab, n_rays, ip, d_op, visits (null: not counted), stream
    "rz_cluster_shadow_inst_grad": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _P, _P, _P],
    # table rows, kernel (1-4: B1-B4; 5, 6: B2-grad, B4-grad) -> bytes of
    # its dynamic shared memory
    "rz_ranked_smem": [_I, _I],
    # group rows, kernel (1, 2: B1, B2) -> bytes of its dynamic shared
    # memory on the grouped walk
    "rz_grouped_smem": [_I, _I],
    # cluster rows, group rows (0: the flat walk), (B2: cutout variant 0 or
    # 1,) out int32[4]: registers per thread, dynamic shared bytes,
    # resident blocks per SM and spilled (local) bytes per thread of B1, B2
    "rz_closest_resources": [_I, _I, _P],
    "rz_shadow_resources": [_I, _I, _I, _P],
    # instance rows, out int32[4] as above, of B3, B4
    "rz_closest_inst_resources": [_I, _P],
    "rz_shadow_inst_resources": [_I, _P],
    # out, pass key words k0, k1, row0, height, width, ns, stream
    "rz_threefry_uniform": [_P, _U, _U, _I, _I, _I, _I, _P],
    # out, key words (uint32[2]), pass index (int32[1]), row0, height,
    # width, ns, stream
    "rz_threefry_uniform_keyed": [_P, _P, _P, _I, _I, _I, _I, _P],
    # table, idx, idx is int64, rows m, row width k, table rows n, out,
    # stream
    "rz_gather_rows": [_P, _P, _I, _L, _I, _I, _P, _P],
    # rows m, table rows n, row width k -> doubles of G2's partials (0: the
    # atomic path)
    "rz_gather_grad_partials": [_L, _I, _I],
    # idx, idx is int64, g, m, k, n, scratch (the partials, or the atomic
    # path's zeroed [n, k] doubles), out, stream
    "rz_gather_rows_grad": [_P, _I, _P, _L, _I, _I, _P, _P, _P],
    # rays n -> floats of the partials that rz_ray_sort_keys takes
    "rz_ray_sort_partials": [_L],
    # origin, direction, n, partials, keys (int64), stream
    "rz_ray_sort_keys": [_P, _P, _L, _P, _P, _P],
    # the bounce's three stages (ops/bounce.py): pointers (void*[np]), np,
    # integers (int64[nv]), nv, stream
    "rz_bounce_head": [_P, _I, _P, _I, _P],
    "rz_bounce_surface": [_P, _I, _P, _I, _P],
    "rz_bounce_tail": [_P, _I, _P, _I, _P],
}
#: return types other than the error code
_RESTYPES = {"rz_gather_grad_partials": _L, "rz_ray_sort_partials": _L}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


@functools.cache
def header_constant(name: str, header: str = "rz_cluster.cuh") -> int | float:
    """The value of ``constexpr int|float <name> = <literal>;`` in a kernel
    header, so that host code and tests read the kernels' sizes from the
    one place that sets them. Raises when the header has no such line."""
    text = (CSRC / header).read_text()
    m = re.search(rf"constexpr\s+(int|float)\s+{name}\s*=\s*([-+0-9.eE]+)f?\s*;",
                  text)
    if m is None:
        raise KeyError(f"{header} has no constexpr {name}")
    return int(m.group(2)) if m.group(1) == "int" else float(m.group(2))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):        # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librz_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; wait for every one, then raise if any
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources(), objs)])
        lib = str(Path(tmp) / "lib.so")
        _run_all([[nvcc, *ARCH, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library. Raises when there
    is no CUDA device or no compiler; there is no fallback."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CUDA kernels need one")
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.rz_error_string.argtypes = [ctypes.c_int]
    lib.rz_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return f"{code} ({load().rz_error_string(code).decode()})"


def ptr(x) -> ctypes.c_void_p:
    """A tensor's data pointer as a ctypes argument."""
    return ctypes.c_void_p(x.data_ptr())


#: every kernel wrapper -> the names of its host counters (function
#: attributes): ``launches`` on each, advanced by :func:`launch`, ``rays``
#: on B1-B4 and ``grouped`` on B1 and B2, advanced by the wrapper
COUNTED: dict = {}


def counted(*counters: str):
    """Decorator: register a kernel wrapper in :data:`COUNTED` with its
    counters, ``launches`` and ``counters``, each a function attribute
    starting at 0."""
    def register(wrapper):
        names = ("launches",) + counters
        for c in names:
            setattr(wrapper, c, 0)
        COUNTED[wrapper] = names
        return wrapper
    return register


def card(dev: torch.device) -> torch.device:
    """``dev``; raises ``ValueError`` unless it is a CUDA device."""
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels run on a CUDA device, got {dev}")
    return dev


def check(dev, name: str, x, dtype, shape=None) -> None:
    """Raise ``ValueError`` unless ``x`` is a contiguous tensor on ``dev``
    of ``dtype`` (or of one of a tuple of dtypes) and, where given, of
    ``shape``."""
    if x.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {x.device}")
    if x.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if shape is not None and x.shape != shape:
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(wrapper, fn, dev, *args) -> None:
    """Call the library function ``fn(*args, stream)`` on CUDA device
    ``dev`` and that device's current stream, whatever device is current in
    the calling thread; raise when it reports an error, else count the
    launch in ``wrapper.launches`` (a :func:`counted` wrapper)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed: "
                           f"{error_string(err)}")
    wrapper.launches += 1
