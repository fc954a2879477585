#!/usr/bin/env python3
"""Disassemble the Hopper kernel library and count what each kernel loads.

    python tools/dump_sass.py [--root DIR] [--match REGEX] --out DIR

Builds the kernel library of the checkout at DIR (default: this one) with
that checkout's own ``kgat_tpu_torch/ops/hopper/build.py``, runs
``cuobjdump -sass`` on it, and for every kernel whose demangled name
matches REGEX writes its SASS to ``OUT/<kernel>.sass`` and prints one
line: instructions, global loads by opcode and width (``LDG.E`` is 4
bytes, ``LDG.E.64`` 8, ``LDG.E.128`` 16), shared-memory loads by width
(``LDS``, ``LDS.64``, ``LDS.128``), float32 FMAs and adds, tensor-core
products (``HMMA`` from mma.sync, ``HGMMA`` from wgmma), asynchronous
global-to-shared copies (``LDGSTS``, from cp.async), shuffles, branches
and the backward branches that close loops. Needs the CUDA toolkit (nvcc,
cuobjdump, cu++filt). A second line gives the same counts for the
kernel's main loop: the body of a backward branch in which FFMA, FADD,
HMMA and HGMMA make the largest share of the instructions.
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def build_library(root: str) -> str:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from kgat_tpu_torch.ops.hopper import build; "
            "print(build.build()[0])")
    out = subprocess.run([sys.executable, "-c", code, root], cwd=root,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def _tool(name: str) -> str:
    for c in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if c and os.path.exists(c):
            return c
    raise RuntimeError(f"{name} not found")


def functions(lib: str):
    """(mangled name, SASS lines) of each kernel in the library."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    name, lines = None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                yield name, lines
            name, lines = m.group(1), []
        elif name:
            lines.append(line)
    if name:
        yield name, lines


def demangle(names):
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    return out.splitlines()


def _counts(ops: collections.Counter) -> str:
    def count(*prefixes):
        return sum(v for k, v in ops.items() if k.startswith(prefixes))

    loads = {k: v for k, v in sorted(ops.items()) if k.startswith("LDG")
             and not k.startswith("LDGSTS")}
    shared = {k: v for k, v in sorted(ops.items()) if k.startswith("LDS")}
    return (f"{sum(ops.values())} instructions, loads {loads}, shared loads "
            f"{shared}, {count('LDGSTS')} LDGSTS, {count('HMMA')} HMMA, "
            f"{count('HGMMA')} HGMMA, {count('FFMA', 'FADD')} FFMA/FADD, "
            f"{count('SHFL')} shuffles, {count('BRA')} branches")


def summary(lines) -> str:
    """The kernel's counts, and those of its main loop: the body of a
    backward branch in which FFMA, FADD, HMMA and HGMMA make the largest
    share of the instructions."""
    instrs = []
    loops = []   # (first address, branch address)
    for line in lines:
        m = INSTR.search(line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(2)
        instrs.append((addr, op))
        if op.startswith("BRA"):
            t = re.search(r"0x([0-9a-f]+)", line.split(op, 1)[1])
            if t and int(t.group(1), 16) <= addr:
                loops.append((int(t.group(1), 16), addr))
    out = (f"{_counts(collections.Counter(op for _, op in instrs))} "
           f"({len(loops)} backward)")
    best = None
    for lo, hi in loops:
        body = collections.Counter(op for a, op in instrs if lo <= a <= hi)
        work = sum(v for k, v in body.items()
                   if k.startswith(("FFMA", "FADD", "HMMA", "HGMMA")))
        share = work / sum(body.values())
        if work and (best is None or share > best[0]):
            best = (share, lo, hi, body)
    if best:
        out += (f"\n    main loop {best[1]:#06x}-{best[2]:#06x}: "
                f"{_counts(best[3])}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=REPO)
    p.add_argument("--match", default=".")
    p.add_argument("--out", required=True, help="directory for the SASS")
    a = p.parse_args(argv)
    lib = build_library(os.path.abspath(a.root))
    funcs = list(functions(lib))
    names = demangle([n for n, _ in funcs])
    os.makedirs(a.out, exist_ok=True)
    print(f"{lib}: {len(funcs)} kernels")
    for i, ((mangled, lines), name) in enumerate(zip(funcs, names)):
        if not re.search(a.match, name):
            continue
        path = os.path.join(a.out, f"{i:03d}_{mangled[:80]}.sass")
        with open(path, "w") as f:
            f.write(name + "\n" + "\n".join(lines) + "\n")
        print(f"{name}\n    {summary(lines)}\n    -> {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
