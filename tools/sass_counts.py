"""Instruction counts of a kernel source's SASS, by opcode and by pipe.

Compiles ``rayzath_tpu_torch/csrc/<name>.cu`` (or any ``.cu`` given by
path) with the kernel library's flags (``ops/_kernels.py`` ``NVCC_FLAGS``:
sm_90a, ``-fmad=false``) to a cubin, disassembles it with ``cuobjdump
-sass`` and prints, per kernel, the static count of each opcode and of
each issue pipe: ``int`` (the integer pipe: IADD3, LOP3, SHF, LEA, ISETP,
SEL, ...), ``fma`` (IMAD, FADD, FMUL, FFMA, ...), ``mem`` (loads, stores,
shuffles) and ``other`` (branches, moves, barriers, ...). The counts are
static: a loop body counts once however often it runs. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), so it runs on the GPU host:

    python3 tools/sass_counts.py threefry [--out chiprun_out/threefry.sass]

The last line is one JSON object, kernel -> {"opcodes", "pipes", "total"}.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PIPES = {
    "int": ("IADD3", "IADD", "LOP3", "LOP", "SHF", "LEA", "ISETP", "SEL",
            "IABS", "IMNMX", "POPC", "FLO", "BREV", "PRMT", "ICMP", "VIADD",
            "PLOP3", "P2R", "R2P", "BMSK", "SGXT", "ISCADD"),
    "fma": ("IMAD", "FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK",
            "I2F", "F2I", "FRND", "MUFU", "DADD", "DMUL", "DFMA", "HFMA2",
            "HADD2", "HMUL2", "IDP", "IMUL"),
    "mem": ("LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ULDC", "SHFL",
            "ATOM", "ATOMS", "RED", "LDGSTS", "LDGDEPBAR", "DEPBAR"),
}


def pipe_of(op: str) -> str:
    for pipe, ops in PIPES.items():
        if op in ops:
            return pipe
    return "other"


def sass(source: Path) -> str:
    from rayzath_tpu_torch.ops import _kernels
    nvcc = _kernels._nvcc()
    cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, str(source)],
                       check=True, timeout=600)
        return subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True, timeout=600).stdout


def counts(text: str) -> dict:
    """Per kernel (``Function : <mangled name>``), opcode counts."""
    out: dict[str, collections.Counter] = {}
    current = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m and current is not None:
            current[m.group(1).split(".")[0]] += 1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="a csrc kernel name or a .cu path")
    ap.add_argument("--out", default=None, help="also write the SASS here")
    args = ap.parse_args(argv)
    source = Path(args.source)
    if source.suffix != ".cu":
        source = ROOT / "rayzath_tpu_torch" / "csrc" / f"{args.source}.cu"
    text = sass(source)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    record = {}
    for kernel, ops in counts(text).items():
        pipes = collections.Counter()
        for op, n in ops.items():
            pipes[pipe_of(op)] += n
        record[kernel] = {"opcodes": dict(ops.most_common()),
                          "pipes": dict(pipes), "total": sum(ops.values())}
        print(f"{kernel}: {sum(ops.values())} instructions; pipes "
              f"{dict(pipes)}; opcodes {dict(ops.most_common())}", flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
