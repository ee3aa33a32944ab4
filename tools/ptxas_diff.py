#!/usr/bin/env python3
"""Registers and spills of every kernel instantiation, this tree against
another (a parent commit unpacked with `git archive`), on a machine with
nvcc.

    python3 tools/ptxas_diff.py PARENT_ROOT

Builds both trees' kernel libraries (each tree's own native.load_cuda,
the two trees in parallel processes; a library already built is kept),
reads each build log (nvcc -Xptxas -v) and compares the instantiations
both trees have, by their mangled names with the anonymous-namespace
hash (which nvcc derives from the source's path) removed. Prints the
instantiations whose registers or spill bytes differ and those only one
tree has; the last line is one JSON object with the counts."""
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = ("import sys; sys.path.insert(0, '.');"
         "from drtvam_tpu_torch.native import load_cuda;"
         "from drtvam_tpu_torch.ops import backproject as bp, render as wf;"
         "load_cuda(bp.KERNELS + wf.LIBS, {**bp._SETUP, **wf._SETUP}, "
         "wf._FLAGS)")


def entries(root):
    """{(library, instantiation): (registers, spill stores, spill loads)}
    of the tree's build logs."""
    d = os.path.join(root, "drtvam_tpu_torch", "_build")
    out = {}
    for f in sorted(os.listdir(d)):
        if not (f.startswith("lib") and f.endswith(".so.log")):
            continue
        with open(os.path.join(d, f)) as fh:
            log = fh.read()
        for part in log.split("Compiling entry function '")[1:]:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__#_",
                          part.split("'")[0])
            regs = re.search(r"Used (\d+) registers", part)
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", part)
            spills = tuple(int(x) for x in sp.groups()) if sp else (0, 0)
            out[(f[3:-7], name)] = (int(regs.group(1)) if regs else 0,
                                    *spills)
    return out


def main():
    parent = os.path.abspath(sys.argv[1])
    jobs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=r)
            for r in (ROOT, parent)]
    if any(j.wait() for j in jobs):
        sys.exit("ptxas_diff: a build failed")
    a, b = entries(parent), entries(ROOT)
    differ = {k: (a[k], b[k]) for k in a if k in b and a[k] != b[k]}
    for (lib, name), (old, new) in sorted(differ.items()):
        print(f"{lib} {name}: registers, spill stores, spill loads {old} -> "
              f"{new}")
    for tag, keys in (("parent only", set(a) - set(b)),
                      ("this tree only", set(b) - set(a))):
        for lib, name in sorted(keys):
            regs = (a if tag[0] == "p" else b)[(lib, name)]
            print(f"{tag}: {lib} {name} {regs}")
    libs = sorted({lib for lib, _ in a} & {lib for lib, _ in b})
    print(json.dumps({"libraries_compared": libs,
                      "instantiations_compared": len(set(a) & set(b)),
                      "differ": len(differ),
                      "parent_only": len(set(a) - set(b)),
                      "this_tree_only": len(set(b) - set(a))}))


if __name__ == "__main__":
    main()
