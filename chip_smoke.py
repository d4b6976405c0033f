#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pycmf_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ok line):
 1. device: the card's name and power limit (nvidia-smi);
 2. build: both CUDA kernels, from pycmf_tpu_torch/csrc;
 3. each kernel against its plain PyTorch version at the main-path shapes
    (X 30000 x 11314, k = 20), X in bf16 and in f32, with CUDA-event times;
 4. MU fit of the 20NG-shaped surrogate, bf16 X, through the estimator:
    kernel launches, and the exact (float64) loss non-increasing along the
    fit, replayed as warm-started segments;
 5. the same for a Newton fit (linear links) of the same data;
 6. kernel path versus plain path on the card (20 iterations each solver),
    and phase 4's final loss against the NumPy baseline (2% guard);
 7. transform of 1000 new rows.
Standard output ends with the fits' record, the card's name and power
limit, the kernels' JSON record and, last, {"ok": true, "device": {...}}.
Details go to standard error.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

N, M, K = 30000, 11314, 20
SEED = 0
QUALITY_BAR = 0.02   # bench.py's equal-final-loss guard


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> bool:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)
        return ok


def time_ms(fn, warmup: int = 2, reps: int = 10) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def rel_fro(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm())


def kernel_phase(check, torch, mu_fused, newton_fused):
    """Phase 3: each kernel against its plain version, bf16 and f32 X."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    dev = torch.device("cuda")
    X32 = torch.from_numpy(rng.rand(N, M).astype(np.float32)).to(dev)
    U = torch.from_numpy(np.abs(rng.randn(N, K)).astype(np.float32)).to(dev)
    V = torch.from_numpy(np.abs(rng.randn(M, K)).astype(np.float32)).to(dev)
    # Newton's inputs: X = U_true V_nᵀ + noise with zero-mean V_n, a
    # well-conditioned least-squares problem per row. (With all-positive V
    # the step U − d cancels to a few percent of |U|, and both versions'
    # f32 rounding, amplified by cond(VᵀV), differs by more than 1e-4 of
    # the result; that would measure the data, not the kernel.)
    Ut = torch.from_numpy(np.abs(rng.randn(N, K)).astype(np.float32)).to(dev)
    Vn = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(dev)
    Xn32 = Ut @ Vn.T + (X32 - 0.5)
    del Ut
    l1, l2, eps, pert, trials = 1e-3, 2e-3, 1e-10, 0.2, 8
    VtV = V.T @ V
    BtB = Vn.T @ Vn
    L = torch.linalg.cholesky(BtB + (l2 + pert) * torch.eye(K, device=dev))
    Hinv = torch.cholesky_solve(torch.eye(K, device=dev), L)
    rec = {}
    for xname, cast in (("bfloat16", lambda a: a.to(torch.bfloat16)),
                        ("float32", lambda a: a)):
        X, Xn = cast(X32), cast(Xn32)
        row_sq = (Xn.float() ** 2).sum(dim=1)
        log(f"phase 3: X {xname}")
        # K1
        out = mu_fused.fused_mu_u_pass(X, U, V, VtV, l1, l2, eps)
        torch.cuda.synchronize()
        ref = mu_fused.fused_mu_u_pass_ref(X, U, V, VtV, l1, l2, eps)
        torch.cuda.synchronize()
        err = float((out[0] - ref[0]).abs().max())
        check(bool(torch.allclose(out[0], ref[0], rtol=1e-4, atol=0.0)),
              f"K1[{xname}] U_new rtol 1e-4 (max abs err {err:.3g})")
        for i, nm in ((1, "numV"), (2, "gramU")):
            e = rel_fro(out[i], ref[i])
            check(e <= 1e-4, f"K1[{xname}] {nm} rel Frobenius {e:.3g} <= 1e-4")
        ms = time_ms(lambda: mu_fused.fused_mu_u_pass(X, U, V, VtV, l1, l2,
                                                       eps))
        pms = time_ms(lambda: mu_fused.fused_mu_u_pass_ref(X, U, V, VtV, l1,
                                                           l2, eps))
        log(f"  K1[{xname}] kernel {ms:.4f} ms, plain {pms:.4f} ms")
        rec[("fused_mu_u_pass", xname)] = dict(max_abs_err=err, ms=ms,
                                               plain_ms=pms)
        # K2
        kw = dict(trials=trials, non_negative=True)
        args = (Xn, U, Vn, BtB, Hinv, row_sq, l1, l2)
        out = newton_fused.fused_newton_linear_u_pass(*args, **kw)
        torch.cuda.synchronize()
        ref = newton_fused.fused_newton_linear_u_pass_ref(*args, **kw)
        torch.cuda.synchronize()
        err = float((out[0] - ref[0]).abs().max())
        # a row agrees when its largest deviation is within 1e-4 of its
        # largest entry; a line-search tie may flip a few rows
        row_dev = (out[0] - ref[0]).abs().amax(dim=1)
        row_scale = ref[0].abs().amax(dim=1).clamp_min(1e-30)
        agree = float((row_dev <= 1e-4 * row_scale).float().mean())
        check(agree >= 0.999, f"K2[{xname}] U_new rows agreeing to rtol "
              f"1e-4: {agree:.6f} >= 0.999 (max abs err {err:.3g})")
        e = rel_fro(out[1], ref[1])
        check(e <= 1e-3, f"K2[{xname}] numV rel Frobenius {e:.3g} <= 1e-3")
        ms = time_ms(lambda: newton_fused.fused_newton_linear_u_pass(
            *args, **kw))
        pms = time_ms(lambda: newton_fused.fused_newton_linear_u_pass_ref(
            *args, **kw))
        log(f"  K2[{xname}] kernel {ms:.4f} ms, plain {pms:.4f} ms")
        rec[("fused_newton_linear_u_pass", xname)] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms)
        del X, Xn, row_sq, out, ref, args
    del X32, Xn32
    torch.cuda.empty_cache()
    return rec


def fit_phase(check, make_est, X, Y, kernel, label):
    """Fit through the estimator; check the kernel's launches and the
    objective along the fit.

    The eval-point losses the fit reports come from the factored identity
    with XᵀU_new taken at bf16-rounded U_new (the reference's zero-extra-
    pass loss), which is noisy at ~1e-4 relative on this data. Monotonicity
    is therefore checked on the exact objective (float64, on the host) at
    each eval point, along the same trajectory replayed as warm-started
    segments of eval_every iterations; the replay must end on the fit's
    own factors bit for bit."""
    import numpy as np

    from baselines import numpy_cmf
    from pycmf_tpu_torch.ops.kernels.policy import launch_counts
    from pycmf_tpu_torch.utils.init import initialize_factors

    est = make_est()
    before = launch_counts().get(kernel, 0)
    t0 = time.perf_counter()
    est.fit_transform(X, Y)
    wall = time.perf_counter() - t0
    launches = launch_counts().get(kernel, 0) - before
    hist = est.loss_history_
    check(all(math.isfinite(v) for v in hist), f"{label}: finite losses")
    check(launches >= est.n_iter_,
          f"{label}: {kernel} launches {launches} >= n_iter {est.n_iter_}")
    ms_iter = 1e3 * sum(est.step_times_) / est.n_iter_
    x_bytes = X.shape[0] * X.shape[1] * 2   # bf16 storage
    log(f"  {label}: n_iter {est.n_iter_}, final loss "
        f"{est.reconstruction_err_:.9g}, {ms_iter:.4f} ms/iter "
        f"(solver loop), fit wall {wall:.3f} s incl. ingest, one X pass "
        f"per iter {x_bytes / (ms_iter * 1e-3) / 1e9:.1f} GB/s, kernel's "
        f"two X reads {2 * x_bytes / (ms_iter * 1e-3) / 1e9:.1f} GB/s")

    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    U, V, Z = initialize_factors(X, Y, K, random_state=SEED)
    exact = [numpy_cmf.loss(X64, Y64, U, V, Z)]
    step = est.eval_every
    for done in range(0, est.n_iter_, step):
        n = min(step, est.n_iter_ - done)
        seg = make_est().set_params(max_iter=n, eval_every=n, tol=0.0)
        U, V, Z = seg.fit_transform(X, Y, U=U, V=V, Z=Z)
        exact.append(numpy_cmf.loss(X64, Y64, U, V, Z))
    check(np.array_equal(U, est.U_) and np.array_equal(V, est.V_),
          f"{label}: warm-started replay ends on the fit's factors")
    rises = [(est.loss_iters_[i + 1], (b - a) / a)
             for i, (a, b) in enumerate(zip(exact, exact[1:])) if b > a]
    dev = max(abs(h - e) / e for h, e in zip(hist, exact))
    log(f"  {label}: reported losses {hist}")
    log(f"  {label}: exact f64 losses {exact}")
    check(all(r <= 1e-6 for _, r in rises),
          f"{label}: exact loss non-increasing up to rel 1e-6 (rises at "
          f"(iter, rel): {rises}); reported vs exact max rel {dev:.3g}")
    return est, dict(n_iter=est.n_iter_, loss=est.reconstruction_err_,
                     exact_loss=exact[-1], ms_per_iter=ms_iter,
                     launches=launches, wall_s=wall,
                     reported_vs_exact_max_rel=dev)


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script "
            "needs a CUDA card")
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pycmf_tpu_torch")):
        log(f"chip_smoke: no pycmf_tpu_torch package beside {__file__}")
        return 2
    sys.path.insert(0, root)
    import numpy as np

    from baselines import numpy_cmf
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels import _build, mu_fused, newton_fused
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.utils.datasets import synthetic_20ng
    from pycmf_tpu_torch.utils.init import initialize_factors

    check = Checks()
    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi gave no output"
    log(f"phase 1: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"phase 2: built in {time.perf_counter() - t0:.1f} s {secs}")
    for lib in _build.NAMES:
        for line in _build.build_log(lib).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {lib}: {line.strip()}")

    # 3. kernels against their plain versions
    krec = kernel_phase(check, torch, mu_fused, newton_fused)

    # 4./5. the main path: MU and Newton fits through the estimator
    t0 = time.perf_counter()
    X, Y = synthetic_20ng(random_state=SEED)
    log(f"phase 4: data {X.shape} nnz={X.nnz} in "
        f"{time.perf_counter() - t0:.1f} s")
    common = dict(n_components=K, data_dtype="bfloat16", random_state=SEED,
                  device="cuda")
    reset_launch_counts()   # counts from here to phase 5's end: main path
    mu_est, mu = fit_phase(
        check, lambda: CMF(solver="mu", max_iter=200, tol=1e-4,
                           eval_every=10, **common),
        X, Y, "fused_mu_u_pass", "MU fit")
    log("phase 5: Newton fit")
    _, nt = fit_phase(
        check, lambda: CMF(solver="newton", max_iter=50, tol=1e-5,
                           eval_every=5, **common),
        X, Y, "fused_newton_linear_u_pass", "Newton fit")
    main_counts = launch_counts()
    check(main_counts.get("fused_mu_u_pass", 0) > 0
          and main_counts.get("fused_newton_linear_u_pass", 0) > 0,
          f"main path launched both kernels: {main_counts}")

    # 6. kernel path against plain path on the card; the 2% guard
    log("phase 6: kernel path vs plain path, 20 iterations")
    for solver, mod, fn in (("mu", mu_fused, "fused_mu_u_pass"),
                            ("newton", newton_fused,
                             "fused_newton_linear_u_pass")):
        kw = dict(solver=solver, max_iter=20, tol=0.0, eval_every=5, **common)
        lk = CMF(**kw).fit(X, Y).reconstruction_err_
        with mock.patch.object(mod, fn, getattr(mod, fn + "_ref")):
            lp = CMF(**kw).fit(X, Y).reconstruction_err_
        gap = abs(lk - lp) / abs(lp)
        check(gap <= 1e-3, f"{solver}: kernel {lk:.9g} vs plain {lp:.9g}, "
              f"rel gap {gap:.3g} <= 1e-3")
    U0, V0, Z0 = initialize_factors(X, Y, K, random_state=SEED)
    t0 = time.perf_counter()
    out = numpy_cmf.run_mu(
        X.astype(np.float32), Y.astype(np.float32), U0.astype(np.float32),
        V0.astype(np.float32), Z0.astype(np.float32), max_iter=200, tol=1e-4,
        eval_every=10)
    ref_loss = float(out[4][-1])
    gap = abs(mu["loss"] - ref_loss) / ref_loss
    check(gap <= QUALITY_BAR, f"MU final loss {mu['loss']:.9g} vs NumPy f32 "
          f"baseline {ref_loss:.9g} ({out[3]} iters, "
          f"{time.perf_counter() - t0:.1f} s): gap {gap:.4%} <= 2%")

    # 7. transform
    Ut = mu_est.transform(X[:1000])
    check(Ut.shape == (1000, K) and bool(np.all(np.isfinite(Ut))),
          f"transform(X[:1000]) -> {Ut.shape}, finite")

    if check.failed:
        log(f"chip_smoke: {len(check.failed)} check(s) failed: "
            + "; ".join(check.failed))
        return 1
    kernels = []
    for kname, src, replaces in (
            ("fused_mu_u_pass", "pycmf_tpu_torch/csrc/mu_fused.cu",
             "pycmf_tpu/ops/pallas/mu_fused.py:143"),
            ("fused_newton_linear_u_pass",
             "pycmf_tpu_torch/csrc/newton_fused.cu",
             "pycmf_tpu/ops/pallas/newton_fused.py:179")):
        bf, f32 = krec[(kname, "bfloat16")], krec[(kname, "float32")]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main_counts.get(kname, 0),
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
            "plain_ms": bf["plain_ms"], "f32_max_abs_err": f32["max_abs_err"],
            "f32_ms": f32["ms"], "f32_plain_ms": f32["plain_ms"]})
    print(json.dumps({"mu_fit": mu, "newton_fit": nt}))
    print(f"{name} | nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
