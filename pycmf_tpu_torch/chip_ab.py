"""A/B timing of the sigmoid Newton kernels (K3, K4, K5) across checkouts.

    python3 -m pycmf_tpu_torch.chip_ab TREE_A TREE_B ...

Each TREE is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory). Every tree's
libraries are built first, in parallel, with the ptxas registers and spills
of their k = 20 kernels; then ``chip_smoke.sigmoid_phase`` (K3, K4, K5
against their plain versions, with CUDA-event times) runs once per tree in
the order A B ... B A, each run in its own process from that tree, printing
one JSON object per run. Compare versions within one invocation only: two
invocations may land on cards with other power limits. Exits non-zero if a
build or a check fails. Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

NAMES = ("sigmoid_newton", "batched_solve")
BUILD = """
from pycmf_tpu_torch.ops.kernels import _build
_build.NAMES = {names!r}
_build.build_all()
for name in _build.NAMES:
    entry = ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif ("registers" in line or "spill" in line) and "Li20E" in entry:
            print(name, entry, line.strip())
"""
RUN = """
import json, torch, chip_smoke as cs
from pycmf_tpu_torch.ops.kernels import sigmoid_newton, batched_solve
check = cs.Checks()
rec = cs.sigmoid_phase(check, torch, sigmoid_newton, batched_solve)
print(json.dumps({"kernels": {" ".join(map(str, k)): v for k, v in rec.items()},
                  "failed": check.failed}))
"""


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    builds = [subprocess.Popen([sys.executable, "-c",
                                BUILD.format(names=NAMES)], cwd=t,
                               stdout=subprocess.PIPE, text=True)
              for t in trees]
    ok = True
    for tree, proc in zip(trees, builds):
        out = proc.communicate()[0]
        ok &= proc.returncode == 0
        print(json.dumps({"tree": tree, "build_rc": proc.returncode,
                          "ptxas": out.splitlines()}), flush=True)
    if not ok:
        return 1
    for tree in trees + trees[::-1]:
        r = subprocess.run([sys.executable, "-c", RUN], cwd=tree,
                           capture_output=True, text=True)
        rec = (json.loads(r.stdout.strip().splitlines()[-1])
               if r.returncode == 0 else {"error": r.stderr[-3000:]})
        ok &= r.returncode == 0 and not rec.get("failed")
        print(json.dumps({"tree": tree, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
