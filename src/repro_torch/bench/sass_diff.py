"""Compare the machine code of two builds of kernel sources, function by
function.

    python -m repro_torch.bench.sass_diff --base DIR

``DIR`` is another checkout of this repository (the parent commit, for
example, unpacked with ``git archive`` under the ignored ``build/``).
Every source of ``kernels/csrc/`` that includes ``hopper.cuh``, the
header the Hopper kernels share, is compiled in both checkouts with the
flags of ``kernels/build.py`` (all ``nvcc`` processes at once),
disassembled with ``cuobjdump -sass``, and each kernel of both builds is
compared instruction by instruction, addresses and encodings left out.
One line a kernel: ``identical``, the count of lines that differ, or the
build it is only in.  A kernel whose SASS is identical runs the same
instructions, so it reads the same times.  Needs ``nvcc`` and
``cuobjdump`` (a machine with the CUDA toolkit); no card is used.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

from repro_torch.bench.ssd_ab import compile_source
from repro_torch.kernels import build

CSRC = Path("src/repro_torch/kernels/csrc")
#: an anonymous namespace's mangled name, which nvcc makes unique to a build
_ANON = re.compile(r"_GLOBAL__N__\w+?_cu_\w{8}")


def functions(sass: str) -> Dict[str, List[str]]:
    """``cuobjdump -sass`` output as {kernel: instructions}, each with its
    address comment and encoding left out."""
    out: Dict[str, List[str]] = {}
    body = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            body = out.setdefault(_ANON.sub("ANON", m.group(1)), [])
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        ins = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ins).strip()
        if ins and body is not None:
            body.append(ins)
    return out


def compare(base: Dict[str, List[str]],
            this: Dict[str, List[str]]) -> Dict[str, str]:
    """{kernel: verdict} over the kernels of both builds."""
    res = {}
    for name in sorted(set(base) | set(this)):
        if name not in this or name not in base:
            res[name] = f"only in {'base' if name in base else 'this'}"
            continue
        b, t = base[name], this[name]
        nd = sum(x != y for x, y in zip(b, t)) + abs(len(b) - len(t))
        res[name] = (f"{'identical' if nd == 0 else f'{nd} lines differ'}"
                     f" ({len(b)} / {len(t)} instructions)")
    return res


def _sass(lib: Path) -> Dict[str, List[str]]:
    tool = Path(build._nvcc()).parent / "cuobjdump"
    return functions(subprocess.run([str(tool), "-sass", str(lib)],
                                    capture_output=True, text=True,
                                    check=True).stdout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path, required=True)
    args = ap.parse_args(argv)
    this = build.CSRC.parents[3]
    sources = sorted(
        p.stem for p in build.CSRC.glob("*.cu")
        if '"hopper.cuh"' in p.read_text())
    jobs = [(s, tag, root) for s in sources
            for tag, root in (("base", args.base.resolve()), ("this", this))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: compile_source(
            j[2] / CSRC / f"{j[0]}.cu", f"sass-{j[0]}-{j[1]}"), jobs))
    built = {(s, tag): lib for (s, tag, _), lib in zip(jobs, libs)}
    for s in sources:
        verdicts = compare(_sass(built[s, "base"]), _sass(built[s, "this"]))
        for name, verdict in verdicts.items():
            print(f"{s}.cu: sass {verdict}: {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
