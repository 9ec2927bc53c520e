"""Device ms of G1's two kernels against each other, per width.

``csrc/gather_rows.cu`` copies rows with ``gather_kernel`` (four output
elements a thread, any width) and, for widths that are a multiple of 4
words on a 16-byte aligned table, ``gather_vec_kernel`` (one 16-byte row
vector a thread). This script includes that source in a wrapper with one C
entry point per kernel and index type, builds it with the kernel library's
flags (``ops/_kernels.py`` ``NVCC_FLAGS``), and on the calls of
:data:`CALLS` (the main path's widths and row counts, seeded indices)
launches each kernel that applies, checks its output bit for bit against
``table[idx]`` and prints the median device ms per launch (a
``torch.profiler`` trace; rounds of ``--runs`` launches per kernel, the
kernels in turn, so the round medians' range is the spread within the
call). Needs ``nvcc`` and a card:

    python3 tools/gather_widths.py [--rounds 5] [--runs 20]

The last line is one JSON object, call -> kernel -> {"ms", "rounds"}.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

#: kernel -> whether it copies 16-byte row vectors
VARIANTS = {"gather_kernel": False, "gather_vec_kernel": True}

#: call -> (table rows n, width k, table dtype, index rows, corners per
#: row, index dtype): the material table (262,144 rays over [6, 14]), a
#: light table's width 3, the texture fetch's block lookup (int64 texel
#: indices into [8192, 4] int32) and its corner texels (1,048,576 int32
#: corner indices into a [8192, 4] colour atlas or, at width 1, a scalar
#: one), and tri_pack's rows ([4096, 32], 262,144 hits)
CALLS = {
    "mat_k14_i32": (6, 14, "float32", 262144, 1, "int32"),
    "mat_k14_i64": (6, 14, "float32", 262144, 1, "int64"),
    "light_k3_i64": (4, 3, "float32", 262144, 1, "int64"),
    "blk_k4_i64": (8192, 4, "int32", 262144, 1, "int64"),
    "texel_k4_i32": (8192, 4, "float32", 262144, 4, "int32"),
    "texel_k1_i32": (32768, 1, "float32", 262144, 4, "int32"),
    "tri_k32_i32": (4096, 32, "float32", 262144, 1, "int32"),
}


def applies(variant: str, k: int) -> bool:
    return k % 4 == 0 or not VARIANTS[variant]


def entry(variant: str, idx_type: str) -> str:
    return f"rzw_{variant}_{'i64' if idx_type == 'long long' else 'i32'}"


def wrapper(source: Path) -> str:
    """The wrapper's source: per kernel and index type, a C function
    (table, idx, m, k, n, out, stream) launching it with
    ``launch_gather``'s grid."""
    out = [f'#include "{source}"']
    for kernel, vec in VARIANTS.items():
        for idx_type in ("int", "long long"):
            width = "k / 4" if vec else "k"
            work = "m * (k / 4)" if vec else "(m * k + 3) / 4"
            word = "uint4" if vec else "uint32_t"
            extra = "" if vec else ", true"
            out.append(f"""
extern "C" int {entry(kernel, idx_type)}(const void* table, const void* idx,
    long long m, int k, int n, void* out, void* stream) {{
  long long b = ({work} + G1_THREADS - 1) / G1_THREADS;
  if (b > G1_MAX_BLOCKS) b = G1_MAX_BLOCKS;
  {kernel}<{idx_type}, uint32_t><<<(unsigned)b, G1_THREADS, 0,
      (cudaStream_t)stream>>>((const {word}*)table,
      (const {idx_type}*)idx, (uint32_t)m, {width}, n{extra}, ({word}*)out);
  return (int)cudaGetLastError();
}}""")
    return "\n".join(out) + "\n"


def build(tmp: str) -> ctypes.CDLL:
    from rayzath_tpu_torch.ops import _kernels
    src = Path(tmp) / "gather_widths.cu"
    src.write_text(wrapper(_kernels.CSRC / "gather_rows.cu"))
    lib = str(Path(tmp) / "libgather_widths.so")
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o",
                    lib, str(src)], check=True, timeout=900)
    return ctypes.CDLL(lib)


def call_args(name: str, dev):
    n, k, dtype, rows, corners, idx_dtype = CALLS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = (n, k) if k > 1 else (n,)
    table = (rng.integers(0, n, size=shape).astype(np.int32)
             if dtype == "int32" else
             rng.uniform(-10, 10, size=shape).astype(np.float32))
    # coherent runs of 16, as neighbouring rays hit neighbouring texels
    base = np.repeat(rng.integers(0, n, size=-(-rows // 16)), 16)[:rows]
    idx = np.minimum(base[:, None] + np.arange(corners), n - 1)
    idx = idx.reshape(-1) if corners == 1 else idx
    return (torch.as_tensor(table, device=dev),
            torch.as_tensor(idx.astype(idx_dtype), device=dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        for name, (n, k, *_rest) in CALLS.items():
            table, idx = call_args(name, dev)
            want = table[idx]
            idx_type = "long long" if idx.dtype == torch.int64 else "int"
            variants = [v for v in VARIANTS if applies(v, k)]
            launches = {}
            for v in variants:
                out = torch.empty_like(want)
                fn = getattr(lib, entry(v, idx_type))
                args_v = (ctypes.c_void_p(table.data_ptr()),
                          ctypes.c_void_p(idx.data_ptr()),
                          ctypes.c_longlong(idx.numel()), k, n,
                          ctypes.c_void_p(out.data_ptr()), stream)
                if fn(*args_v) != 0:
                    raise RuntimeError(f"{v} on {name}: launch failed")
                if not torch.equal(out.view(torch.int32),
                                   want.view(torch.int32)):
                    raise RuntimeError(f"{v} on {name}: not table[idx]")
                launches[v] = (fn, args_v)
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(args.rounds):
                    for v in variants:
                        fn, args_v = launches[v]
                        for _ in range(args.runs):
                            fn(*args_v)
                torch.cuda.synchronize(dev)
            times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            per = args.runs * len(variants)
            if len(times) != per * args.rounds:
                raise RuntimeError(f"{len(times)} kernels traced on {name}, "
                                   f"expected {per * args.rounds}")
            rec = {}
            for j, v in enumerate(variants):
                rounds = [statistics.median(
                    times[r * per + j * args.runs:
                          r * per + (j + 1) * args.runs])
                          for r in range(args.rounds)]
                rec[v] = {"ms": statistics.median(rounds), "rounds": rounds}
            result[name] = rec
            print(f"{name} [{card}]: " + "; ".join(
                f"{v} {r['ms']:.4f} ms (rounds {min(r['rounds']):.4f}-"
                f"{max(r['rounds']):.4f})" for v, r in rec.items()),
                flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
