#!/usr/bin/env python3
"""Compare the sweep kernel's SASS between two versions of its source.

    python tools/sweep_sass_diff.py [--graph-free] OLD_SWEEP_CU [NEW_SWEEP_CU]

Builds both sources with the sweep library's own flags
(``repro_torch.kernels._build.NVCC_FLAGS``) and compares, instance by
instance, the instructions of every template instance of
``sweep_kernel`` the old source has with the new source's instance of
the same arguments (a trailing template parameter one source lacks
counts as ``false``).  With ``--graph-free`` only the old source's
graph-free instances are compared (its fifth parameter, ``HAS_GRAPH``,
false or absent): in newer sources the graph instances are a kernel of
their own, ``graph_kernel``.  The new source defaults to the checkout's
``src/repro_torch/csrc/sweep.cu``.  Prints one line per instance and
exits nonzero when any differs or is missing.  Needs ``nvcc`` and
``cuobjdump`` (the machine with the card).
"""

import pathlib
import re
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import _build  # noqa: E402

INSTANCE = re.compile(r"sweep_kernelI((?:Lb[01]E)+)E")
INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)")


def sass_by_instance(source: pathlib.Path, out_dir: pathlib.Path) -> dict:
    """{template bools: [instruction, ...]} of one source's library."""
    lib = out_dir / (source.stem + f"-{abs(hash(str(source)))}.so")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(lib), str(source)],
                   check=True)
    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for body in sass.split("Function : ")[1:]:
        head, _, rest = body.partition("\n")
        m = INSTANCE.search(head)
        if m:
            bools = tuple(int(b) for b in re.findall(r"Lb([01])E",
                                                     m.group(1)))
            out[bools] = INSTRUCTION.findall(rest)
    return out


def main(argv) -> int:
    graph_free = "--graph-free" in argv
    argv = [a for a in argv if a != "--graph-free"]
    if not 1 <= len(argv) <= 2:
        print(__doc__)
        return 2
    old_src = pathlib.Path(argv[0])
    new_src = pathlib.Path(argv[1]) if len(argv) > 1 else \
        REPO / "src/repro_torch/csrc/sweep.cu"
    with tempfile.TemporaryDirectory() as tmp:
        old = sass_by_instance(old_src, pathlib.Path(tmp))
        new = sass_by_instance(new_src, pathlib.Path(tmp))
    if graph_free:
        old = {k: v for k, v in old.items() if not k[4:5] == (1,)}
    width = max(len(k) for k in (*old, *new)) if new else 0
    new = {k + (0,) * (width - len(k)): v for k, v in new.items()}
    bad = 0
    for key, instrs in sorted(old.items()):
        twin = new.get(key + (0,) * (width - len(key)))
        same = twin == instrs
        bad += not same
        print(f"instance {key}: {len(instrs)} instructions, "
              + ("identical" if same else "missing" if twin is None
                 else f"DIFFERS ({len(twin)} instructions in the new "
                      f"source)"))
    print(f"{len(old) - bad} of {len(old)} instances identical; the new "
          f"source adds {len(new) - len(old)}")
    return 1 if bad or not old else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
