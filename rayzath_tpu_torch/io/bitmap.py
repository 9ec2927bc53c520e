"""Bitmap load/save (the stb_image / BitmapSaver analog, reference
loader.cpp + saver.cpp:22-66). A copy of ``rayzath_tpu/io/bitmap.py``: PNG
and JPEG go through PIL and raise when PIL is not installed; Radiance
``.hdr`` and float ``.npy`` maps decode in NumPy.
"""
from __future__ import annotations

import os

import numpy as np

try:
    from PIL import Image
    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


def load_image(path: str, flip_v: bool = False) -> np.ndarray:
    """Load an image as float32 RGBA [H,W,4] in [0,1]."""
    if not _HAS_PIL:
        raise RuntimeError("PIL is unavailable; cannot load images")
    img = Image.open(path).convert("RGBA")
    a = np.asarray(img, np.float32) / 255.0
    if flip_v:
        a = a[::-1]
    return a


def load_hdr(path: str) -> np.ndarray:
    """Load a high-dynamic-range image as float32 RGB [H,W,3] (linear).

    Supports Radiance ``.hdr`` (RGBE: new-RLE, old-RLE and flat scanlines; pure NumPy —
    the stb_image HDR path of the reference, loader.cpp:103-138, without the
    C dependency) and float ``.npy`` arrays ([H,W,3] or [H,W]). ``.exr``
    needs OpenEXR, which is not available in this environment."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        a = np.asarray(np.load(path), np.float32)
        if a.ndim == 2:
            a = np.repeat(a[..., None], 3, axis=2)
        return a[:, :, :3]
    if ext == ".exr":  # pragma: no cover
        raise RuntimeError("EXR requires OpenEXR, which is not installed; "
                           "convert to .hdr or .npy")
    if ext != ".hdr":
        raise RuntimeError(f"not an HDR format: {path}")
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"#?"):
        raise RuntimeError(f"{path}: missing Radiance header")
    # header ends at the first empty line; next line is the resolution
    head_end = raw.find(b"\n\n")
    if head_end < 0:
        raise RuntimeError(f"{path}: malformed header")
    pos = head_end + 2
    eol = raw.find(b"\n", pos)
    res = raw[pos:eol].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise RuntimeError(f"{path}: unsupported resolution line {res}")
    height, width = int(res[1]), int(res[3])
    data = np.frombuffer(raw, np.uint8, offset=eol + 1)
    rgbe = np.zeros((height, width, 4), np.uint8)
    p = 0
    for y in range(height):
        if (width >= 8 and width < 32768 and p + 4 <= len(data)
                and data[p] == 2 and data[p + 1] == 2
                and (int(data[p + 2]) << 8 | int(data[p + 3])) == width):
            p += 4  # new RLE: four component planes
            for c in range(4):
                x = 0
                while x < width:
                    n = int(data[p]); p += 1
                    if n > 128:                      # run
                        rgbe[y, x:x + n - 128, c] = data[p]
                        p += 1
                        x += n - 128
                    else:                            # literal
                        rgbe[y, x:x + n, c] = data[p:p + n]
                        p += n
                        x += n
        else:                                        # flat RGBE scanline
            chunk = data[p:p + width * 4]
            # old-style RLE marks runs with (1,1,1,count) pixels; they break
            # the fixed-width framing, so hand the rest of the image to the
            # stateful pixel decoder the moment one appears (or the stream
            # is already too short for flat rows — compressed)
            if len(chunk) < width * 4:
                _decode_old_rle(data, p, rgbe, y, height, width)
                break
            row = chunk.reshape(width, 4)
            marker = (row[:, 0] == 1) & (row[:, 1] == 1) & (row[:, 2] == 1)
            if marker.any():
                _decode_old_rle(data, p, rgbe, y, height, width)
                break
            rgbe[y] = row
            p += width * 4
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0,
                     np.ldexp(np.float32(1.0), e - (128 + 8))).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _decode_old_rle(data: np.ndarray, p: int, rgbe: np.ndarray, y0: int,
                    height: int, width: int) -> None:
    """Old-style Radiance RLE: a (1,1,1,count) pixel repeats the previous
    pixel; consecutive markers shift the count left 8 bits each (the
    encoding stb_image calls "old RLE"; previously misparsed as flat RGBE,
    advisor finding). Decodes rows [y0, height) in place. When the
    flat->old-RLE handoff happens mid-image, the "previous pixel" seed is
    the last pixel of the already-decoded scanline above (a leading run
    marker must repeat it, not black)."""
    prev = rgbe[y0 - 1, -1].copy() if y0 > 0 else np.zeros(4, np.uint8)
    shift = 0
    for y in range(y0, height):
        x = 0
        while x < width:
            if p + 4 > len(data):
                raise RuntimeError("truncated old-RLE .hdr stream")
            px = data[p:p + 4]
            p += 4
            if px[0] == 1 and px[1] == 1 and px[2] == 1:
                n = min(int(px[3]) << shift, width - x)
                rgbe[y, x:x + n] = prev
                x += n
                shift += 8
            else:
                rgbe[y, x] = px
                prev = px
                x += 1
                shift = 0


def hdr_to_texture_emission(rgb: np.ndarray):
    """Split linear HDR rgb into (texture RGBA [0,1], emission map [H,W]) —
    the reference pair semantics (loader.cpp:116-137): texture = chroma
    (rgb / max component), emission = max component."""
    rgb = np.asarray(rgb, np.float32)
    mx = rgb.max(axis=2)
    safe = np.maximum(mx, 1e-20)
    tex = np.concatenate([rgb / safe[..., None],
                          np.ones(rgb.shape[:2] + (1,), np.float32)], axis=2)
    return np.clip(tex, 0.0, 1.0), mx


def save_image(path: str, rgb: np.ndarray) -> None:
    """Save uint8 [H,W,3|4] (or float in [0,1]) as PNG/JPEG by extension."""
    a = np.asarray(rgb)
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    if not _HAS_PIL:
        raise RuntimeError("PIL is unavailable; cannot save images")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(a).save(path)


def save_depth(path: str, depth: np.ndarray) -> None:
    """Save a depth buffer: .npy raw, or normalized grayscale PNG."""
    if path.endswith(".npy"):
        np.save(path, depth)
        return
    d = np.asarray(depth, np.float32)
    finite = np.isfinite(d) & (d < 1e30)
    hi = d[finite].max() if finite.any() else 1.0
    lo = d[finite].min() if finite.any() else 0.0
    norm = np.zeros_like(d) if hi <= lo else np.clip((d - lo) / (hi - lo), 0, 1)
    save_image(path, np.repeat(norm[..., None], 3, axis=2))
