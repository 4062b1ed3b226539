"""Where a kernel's register spills sit in its machine code: dumps the SASS of
the built kernel library with ``cuobjdump`` and, for each kernel whose
mangled name contains one of the given names, counts its wgmma (HGMMA) and
local-memory spill instructions (STL, LDL) in all and inside the innermost
loops that hold a wgmma (a backward branch whose range holds an HGMMA and no
other such loop: the k loops of its products).

    python -m nerfsos_torch.tools.sass_spills [frozen_sem_kernel ...]

``inner_loop`` counts the instructions of a SIMT kernel's pair loop (K7's,
for chip_smoke's issue-rate bound) and ``functions`` splits the library's
SASS by function. Builds the library first if it is missing (needs the
CUDA toolkit: run it on the machine with the card). Prints one JSON line a
kernel.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _innermost_loops(insns, op: str):
    """(first, last) addresses of the loops (a backward branch and its
    target) that hold an ``op`` instruction and no other such loop."""
    loops = []
    for addr, text in insns:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            if any(lo <= a <= addr and op in t for a, t in insns):
                loops.append((lo, addr))
    return [(lo, hi) for lo, hi in loops
            if not any((lo, hi) != (a, b) and lo <= a and b <= hi for a, b in loops)]


def inner_loop(sass: str, op: str = "MUFU") -> dict:
    """Of one function's innermost loops that hold an ``op`` instruction
    (K7's pair loops: their reciprocals' MUFU.RCP), the one with the fewest
    instructions an ``op`` (where a kernel has a fast copy of its loop and
    a guarded one, the fast one): its instructions (NOPs left out) and its
    ``op`` instructions."""
    insns = [(int(a, 16), text) for a, text in _INSN.findall(sass)]
    best = {"insns": 0, op.lower(): 0}
    for lo, hi in _innermost_loops(insns, op):
        body = [t for a, t in insns if lo <= a <= hi and not t.startswith("NOP")]
        n = sum(1 for t in body if op in t)
        if not best["insns"] or len(body) * best[op.lower()] < best["insns"] * n:
            best = {"insns": len(body), op.lower(): n}
    return best


def scan(sass: str) -> dict:
    """Counts for one function's SASS text."""
    insns = [(int(a, 16), text) for a, text in _INSN.findall(sass)]
    # the innermost loops with a wgmma: the k loops, not the tile loops around them
    loops = _innermost_loops(insns, "HGMMA")

    def count(op, inside):
        return sum(1 for a, t in insns if re.search(rf"\b{op}\b", t)
                   and (not inside or any(lo <= a <= hi for lo, hi in loops)))

    return {"hgmma": count("HGMMA", False), "stl": count("STL", False),
            "ldl": count("LDL", False), "wgmma_loops": len(loops),
            "stl_in_wgmma_loops": count("STL", True), "ldl_in_wgmma_loops": count("LDL", True)}


def functions(lib: str) -> dict:
    """Mangled name -> SASS text of every function in the library
    (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    return {part.split("\n", 1)[0].strip(): part
            for part in re.split(r"\n\s*Function : ", sass)[1:]}


def main() -> int:
    names = sys.argv[1:] or ["frozen_sem_kernel", "train_render_wg_kernel"]
    from nerfsos_torch import _build

    try:
        funcs = functions(_build.build())
    except RuntimeError as e:
        print(f"sass_spills: {e}", file=sys.stderr)
        return 1
    for name, part in funcs.items():
        if any(n in name for n in names):
            print(json.dumps({"function": name, **scan(part)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
