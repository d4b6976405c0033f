"""A/B timing of kernels across checkouts.

    python3 -m pycmf_tpu_torch.chip_ab [--phase sigmoid|sparse] TREE_A TREE_B ...

Each TREE is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory). Every tree's
libraries of the phase are built first, in parallel, with the ptxas
registers and spills of their k = 20 kernels; then the phase of
``chip_smoke`` runs once per tree in the order A B ... B A, each run in its
own process from that tree, printing one JSON object per run:

- ``sigmoid`` (the default): ``chip_smoke.sigmoid_phase``, K3, K4 and K5
  against their plain versions;
- ``sparse``: ``chip_smoke.sparse_phase``, csr_spmm, csr_rowdots,
  bell_spmm and fused_mu_update on the 20NG, RCV1 and block-structured
  shapes, and the BlockEll/CSR crossover fill.

Compare versions within one invocation only: two invocations may land on
cards with other power limits. Exits non-zero if a build or a check fails.
Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys

# phase: (libraries, the ptxas entries reported, the phase function)
PHASES = {
    "sigmoid": (("sigmoid_newton", "batched_solve"), ("Li20E",),
                "cs.sigmoid_phase(check, torch, sigmoid_newton, "
                "batched_solve)"),
    # bell_spmm's k = 20 kernel is instantiated at KP = 20 (CUDA-core) or at
    # NT = 3 tiles of 8 columns; the CSR kernels take k at run time
    "sparse": (("csr_spmm", "bell_spmm"),
               ("Li20E", "Li3E", "csr_", "bell_combine", "bell_bt"),
               "cs.sparse_phase(check, torch)"),
}
BUILD = """
from pycmf_tpu_torch.ops.kernels import _build
_build.NAMES = {names!r}
_build.build_all()
for name in _build.NAMES:
    entry = ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif (("registers" in line or "spill" in line)
              and any(tag in entry for tag in {tags!r})):
            print(name, entry, line.strip())
"""
RUN = """
import json, torch, chip_smoke as cs
from pycmf_tpu_torch.ops.kernels import sigmoid_newton, batched_solve
check = cs.Checks()
rec = {call}
print(json.dumps({{"kernels": {{k if isinstance(k, str) else
                                " ".join(map(str, k)): v
                                for k, v in rec.items()}},
                  "failed": check.failed}}))
"""


def main(argv) -> int:
    phase = "sigmoid"
    if argv[:1] == ["--phase"] and len(argv) > 1:
        phase, argv = argv[1], argv[2:]
    if phase not in PHASES or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    names, tags, call = PHASES[phase]
    trees = list(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    builds = [subprocess.Popen([sys.executable, "-c",
                                BUILD.format(names=names, tags=tags)],
                               cwd=t, stdout=subprocess.PIPE, text=True)
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
        r = subprocess.run([sys.executable, "-c", RUN.format(call=call)],
                           cwd=tree, capture_output=True, text=True)
        rec = (json.loads(r.stdout.strip().splitlines()[-1])
               if r.returncode == 0 else {"error": r.stderr[-3000:]})
        ok &= r.returncode == 0 and not rec.get("failed")
        print(json.dumps({"tree": tree, "phase": phase, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
