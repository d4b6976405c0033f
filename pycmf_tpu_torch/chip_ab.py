"""A/B timing of kernels across checkouts.

    python3 -m pycmf_tpu_torch.chip_ab [--phase PHASE] TREE_A TREE_B ...

PHASE is sigmoid (the default), sparse, upass, paths or ties. Each TREE is a
checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory). Every tree's
libraries of the phase are built first, in parallel, with the ptxas
registers and spills of their k = 20 kernels; then the phase of
``chip_smoke`` runs once per tree in the order A B ... B A, each run in its
own process from that tree, printing one JSON object per run:

- ``sigmoid`` (the default): ``chip_smoke.sigmoid_phase``, K3, K4 and K5
  against their plain versions;
- ``sparse``: ``chip_smoke.sparse_phase``, csr_spmm, csr_rowdots,
  bell_spmm and fused_mu_update on the 20NG, RCV1 and block-structured
  shapes, and the BlockEll/CSR crossover fill;
- ``upass``: K1 ``fused_mu_u_pass`` and K2 ``fused_newton_linear_u_pass``
  at the main shape (X 30000 x 11314, k = 20, bf16 and f32), each held
  against its plain version and timed with the host's wrapper (``ms``), on
  the device alone (``device_ms``) and per kernel of the call
  (``kernels_us``, torch.profiler), beside one read of X by ``torch.sum``
  (``x_read``: the rate a plain stream reaches);
- ``paths``: chip_smoke phase 8's kernel-vs-plain fits of MU, Newton linear
  and path A (20 iterations), with the loss at every iteration of both;
- ``ties``: K4 at chip_smoke's k = 1 edge shape (30000 x 4097, trials 8)
  on eight seeds: the share of rows whose selected line-search slot agrees
  with the plain version's, and the share on which each of the two matches
  a float64 evaluation, on all rows and on the rows float64 decides by
  more than 2^-22, 2^-20 and 2^-18 of phi (``chip_smoke.decided_rows``).
  The code of ``upass``, ``paths`` and ``ties`` is this file's (``UPASS``),
  run against each tree's wrappers, so a tree whose chip_smoke predates the
  redesign is timed the same way.

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
    # K3's and K4's tensor-core kernels are instantiated on X's dtype (and
    # K4's on k's mma steps), the CUDA-core ones at KP = 20
    "sigmoid": (("sigmoid_newton", "batched_solve"),
                ("gh_part", "phi_part", "Li20E"),
                "cs.sigmoid_phase(check, torch, sigmoid_newton, "
                "batched_solve)"),
    # bell_spmm's k = 20 kernel is instantiated at KP = 20 (CUDA-core) or at
    # NT = 3 tiles of 8 columns; the CSR kernels take k at run time
    "sparse": (("csr_spmm", "bell_spmm"),
               ("Li20E", "Li3E", "csr_", "bell_combine", "bell_bt"),
               "cs.sparse_phase(check, torch)"),
    # the CUDA-core kernels are instantiated at KP = 20, the tensor-core
    # ones at NT = 3 tiles of 8 columns
    "upass": (("mu_fused", "newton_fused"),
              ("Li20E", "Li3E", "u_pass_reduce", "reduce_parts"),
              "upass_ab(check, torch, cs)"),
    "paths": (("mu_fused", "newton_fused", "sigmoid_newton", "batched_solve",
               "mu_update"), ("Li20E", "Li3E"),
              "paths_ab(check, torch, cs)"),
    "ties": (("sigmoid_newton",), ("phi_part",), "ties_ab(check, torch, cs)"),
}
UPASS = """
def upass_ab(check, torch, cs):
    import numpy as np
    from pycmf_tpu_torch.ops.kernels import mu_fused, newton_fused
    rng = np.random.RandomState(cs.SEED)
    dev = torch.device("cuda")
    N, M, K = cs.N, cs.M, cs.K

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    X32, U, V = f32(rng.rand(N, M)), f32(abs(rng.randn(N, K))), \\
        f32(abs(rng.randn(M, K)))
    Vn = f32(rng.randn(M, K))
    Xn32 = f32(abs(rng.randn(N, K))) @ Vn.T + (X32 - 0.5)
    eye = torch.eye(K, device=dev)
    VtV, BtB = V.T @ V, Vn.T @ Vn
    Hinv = torch.cholesky_solve(eye, torch.linalg.cholesky(BtB + 0.202 * eye))
    rec = {}
    for xname in ("bfloat16", "float32"):
        dt = getattr(torch, xname)
        X, Xn = X32.to(dt), Xn32.to(dt)
        rs = (Xn.float() ** 2).sum(dim=1)
        # yardstick: one read of X by PyTorch's own reduction
        rec[f"x_read[{xname}]"] = dict(device_ms=cs.device_ms(
            lambda: X.sum(dtype=torch.float32)))
        k1 = (mu_fused.fused_mu_u_pass, mu_fused.fused_mu_u_pass_ref,
              (X, U, V, VtV, 1e-3, 2e-3, 1e-10), {})
        k2 = (newton_fused.fused_newton_linear_u_pass,
              newton_fused.fused_newton_linear_u_pass_ref,
              (Xn, U, Vn, BtB, Hinv, rs, 1e-3, 2e-3),
              dict(trials=cs.TRIALS, non_negative=True))
        for name, (fn, ref, args, kw) in (("fused_mu_u_pass", k1),
                                          ("fused_newton_linear_u_pass", k2)):
            got, want = fn(*args, **kw), ref(*args, **kw)
            dev_row = (got[0] - want[0]).abs().amax(dim=1)
            scale = want[0].abs().amax(dim=1).clamp_min(1e-30)
            agree = float((dev_row <= 1e-4 * scale).float().mean())
            e = cs.rel_fro(got[1], want[1])
            check(agree >= 0.999 and e <= 1e-3, f"{name}[{xname}] rows "
                  f"agreeing {agree:.6f}, numV rel Frobenius {e:.3g}")
            run = lambda: fn(*args, **kw)  # noqa: E731
            rec[f"{name}[{xname}]"] = dict(ms=cs.time_ms(run),
                                           device_ms=cs.device_ms(run),
                                           kernels_us=per_kernel(torch, run))
    return rec


def paths_ab(check, torch, cs):
    # chip_smoke phase 8's kernel-vs-plain fits (MU, Newton linear, path A;
    # 20 iterations on the 20NG surrogate) with the loss read at every
    # iteration, so trees can be compared on where the two paths part
    from unittest import mock
    from contextlib import ExitStack
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels import (batched_solve, mu_fused,
                                             mu_update, newton_fused,
                                             sigmoid_newton)
    from pycmf_tpu_torch.utils.datasets import synthetic_20ng
    X, Y = synthetic_20ng(random_state=cs.SEED)
    common = dict(n_components=cs.K, data_dtype="bfloat16",
                  random_state=cs.SEED, device="cuda", max_iter=20, tol=0.0,
                  eval_every=1)
    plain = {"fused_mu_u_pass": mu_fused,
             "fused_newton_linear_u_pass": newton_fused,
             "sigmoid_gh_pass": sigmoid_newton,
             "sigmoid_phi_pass": sigmoid_newton,
             "batched_spd_solve": batched_solve,
             "fused_mu_update": mu_update}
    rec = {}
    for label, kw in (("MU", dict(solver="mu")),
                      ("Newton linear", dict(solver="newton")),
                      ("path A", dict(solver="newton", y_link="sigmoid"))):
        lk = CMF(**kw, **common).fit(X, Y).loss_history_
        with ExitStack() as patches:
            for fn, mod in plain.items():
                patches.enter_context(mock.patch.object(
                    mod, fn, getattr(mod, fn + "_ref")))
            lp = CMF(**kw, **common).fit(X, Y).loss_history_
        rec[label] = dict(kernel=lk, plain=lp,
                          gap=[abs(a - b) / abs(b) for a, b in zip(lk, lp)])
    return rec


def ties_ab(check, torch, cs, seeds=8):
    # K4 at the k = 1 edge shape (30000 x 4097, trials 8, bf16 X), one
    # draw of chip_smoke's edge inputs per seed: the share of rows whose
    # selected line-search slot agrees between kernel and plain version,
    # and the share on which each matches a float64 evaluation
    import numpy as np
    from pycmf_tpu_torch.ops.kernels import sigmoid_newton as sn
    dev = torch.device("cuda")
    l1, l2, pert = 0.5, 1.0, 0.2
    rec = {}
    for seed in range(seeds):
        lab, Mf, Bf = cs.sig_inputs(torch, np.random.RandomState(seed),
                                    cs.N, 4097, 1, dev)
        X = lab.to(torch.bfloat16)
        for nonneg in (True, False):
            Mk = Mf.abs() if nonneg else Mf
            G, H = sn.sigmoid_gh_pass_ref(X, Mk, Bf, l1, l2)
            eye = (l2 + pert) * torch.eye(1, device=dev)
            d = torch.linalg.solve(H + eye, G[..., None])[..., 0]
            kw = dict(trials=cs.TRIALS, non_negative=nonneg)
            got = sn.sigmoid_phi_pass(X, Mk, d, Bf, l1, l2, **kw)
            want = sn.sigmoid_phi_pass_ref(X, Mk, d, Bf, l1, l2, **kw)
            w64 = sn.sigmoid_phi_pass_ref(X.double(), Mk.double(), d.double(),
                                          Bf.double(), l1, l2, **kw)
            rel = float((got - want).abs().max() / want.abs().max())
            check(rel <= 2e-5, f"K4 seed {seed} phi err {rel:.3g} <= 2e-5")
            r = dict(agree=cs.slot_agreement(got, want),
                     kernel_vs_f64=cs.slot_agreement(got, w64),
                     plain_vs_f64=cs.slot_agreement(want, w64))
            # the same on the rows float64 decides by more than 2^-e of phi
            for e in (22, 20, 18):
                rows = cs.decided_rows(w64, 2.0 ** -e)
                r[f"decided_{e}"] = float(rows.float().mean())
                r[f"kernel_vs_f64_{e}"] = cs.slot_agreement(got, w64, rows)
                r[f"plain_vs_f64_{e}"] = cs.slot_agreement(want, w64, rows)
            rec[f"seed={seed} non_negative={nonneg}"] = r
    return rec
def per_kernel(torch, run, reps=5):
    # mean device time in microseconds of each kernel of one call
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name.split("(")[0].replace("void ", "")[:60]
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / reps
    return out
"""
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
{upass}
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
        r = subprocess.run([sys.executable, "-c",
                            RUN.format(call=call, upass=UPASS)],
                           cwd=tree, capture_output=True, text=True)
        rec = (json.loads(r.stdout.strip().splitlines()[-1])
               if r.returncode == 0 else {"error": r.stderr[-3000:]})
        ok &= r.returncode == 0 and not rec.get("failed")
        print(json.dumps({"tree": tree, "phase": phase, **rec}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
