"""Registers, spills and static shared memory of the kernels of K1, K2 and
P1, as ptxas reports them.

    python -m topk_rec_torch.ops.ptxas_report

Compiles ``csrc/topk_fused.cu``, ``csrc/topk_count.cu`` and
``csrc/topk_floor.cu`` with the build's nvcc flags plus ``-Xptxas -v`` (one
process per source, all started together) and prints one line per kernel
entry: P1's in both modes (``tile``) and both variants (``variant`` A, the
max only, or B, with its item). Needs ``nvcc``; the kernel
build itself (``ops/_build.py``) does not run this.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

from ._build import CSRC, NVCC_FLAGS, _nvcc


def ptxas_report(sources=("topk_fused.cu", "topk_count.cu",
                          "topk_floor.cu")):
    """[(source, entry, registers, spill stores, spill loads, static shared
    bytes)] for each kernel entry of ``sources``."""
    nvcc = _nvcc()
    work = tempfile.mkdtemp()
    try:
        procs = [(src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             os.path.join(work, src + ".o"), os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for src in sources]
        out = []
        for src, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc -Xptxas -v {src}:\n{err[-4000:]}")
            entry, spill = None, (0, 0)
            for line in err.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    entry, spill = m.group(1), (0, 0)
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if m:
                    spill = (int(m.group(1)), int(m.group(2)))
                m = re.search(r"Used (\d+) registers", line)
                if m and entry is not None:
                    smem = re.search(r"(\d+) bytes smem", line)
                    out.append((src, entry, int(m.group(1)), *spill,
                                int(smem.group(1)) if smem else 0))
                    entry, spill = None, (0, 0)
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def variant(entry: str) -> str:
    """P1's variant from its mangled ``bool`` template argument (``Lb0E``:
    A, ``Lb1E``: B); "-" for the other kernels."""
    if "floor_" not in entry:
        return "-"
    flag = re.search(r"Lb([01])E", entry)
    return ("B" if flag.group(1) == "1" else "A") if flag else "-"


def main() -> int:
    for src, entry, regs, st, ld, smem in ptxas_report():
        kind = re.search(r"topk_pass1|count_pass|topk_merge|floor_pass|"
                         r"floor_merge", entry)
        rows = re.search(r"ILi(\d+)E", entry)
        tile = ("fp32" if "FmaTile" in entry else
                "bf16" if "MmaTile" in entry else "-")
        print(f"[ptxas] source={src} "
              f"kernel={kind.group(0) if kind else entry} "
              f"rows={rows.group(1) if rows else '-'} tile={tile} "
              f"variant={variant(entry)} "
              f"registers={regs} spill_stores={st} spill_loads={ld} "
              f"static_smem={smem}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
