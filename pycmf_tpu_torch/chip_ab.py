"""A/B timing of kernels across checkouts.

    python3 -m pycmf_tpu_torch.chip_ab [--phase PHASE] TREE_A TREE_B ...

PHASE is sigmoid (the default), sparse, upass, paths, k5k6, k5block,
k5wide, ties or loops. Each
TREE is a checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory). Every tree's
libraries of the phase are built first, in parallel, with the ptxas
registers and spills of their k = 20 kernels; then the phase of
``chip_smoke`` runs once per tree in the order A B ... B A, each run in its
own process from that tree, printing one JSON object per run (each
tree's build also prints the machine instructions of those kernels, from
``cuobjdump -sass`` where the toolkit has it):

- ``sigmoid`` (the default): ``chip_smoke.sigmoid_phase``, K3, K4 and K5
  against their plain versions;
- ``sparse``: ``chip_smoke.sparse_phase``, csr_spmm, csr_rowdots,
  bell_spmm and fused_mu_update on the 20NG, RCV1 and block-structured
  shapes, and the BlockEll/CSR crossover fill;
- ``upass``: K1 ``fused_mu_u_pass`` and K2 ``fused_newton_linear_u_pass``
  at the main shape (X 30000 x 11314, bf16 and f32, k = 20 and the wide
  route's k = 40, 64 and 100; then X rounded to e4m3 at k = 20, 40 and
  100, each beside its bf16 form on X widened to bf16, which it must equal
  bit for bit), each held against its plain version (and timed beside it,
  ``plain_ms``), two calls bitwise equal, and timed with the host's
  wrapper (``ms``), on the device alone (``device_ms``) and per kernel of
  the call (``kernels_us``, torch.profiler), its outputs digested
  (``bitwise``: the trees' bits must agree; f32 X's ``digest`` at k = 20
  is not compared, its summation order being free to change), beside one
  read of X by ``torch.sum`` (``x_read``: the
  rate a plain stream reaches; for e4m3 a sum over X's uint8 view, which
  PyTorch's integer reduction does not run at a streaming rate);
- ``paths``: chip_smoke phase 8's kernel-vs-plain fits of MU, Newton linear
  and path A (20 iterations), with the loss at every iteration of both;
- ``k5k6``: K6 ``fused_mu_update`` at 20 x 20, 11314 x 20, 804414 x 20
  and 11314 x 40 (ms, device ms, and a digest of each output: the digests
  of every run must agree, so the trees' outputs are equal bit for bit);
  K5 ``batched_spd_solve`` at p = 20, 11314 and 30000 systems of 20 x 20
  with L2 flushed, given H whole and as the Newton solver passes it
  (``path_*``: H_rows and H_shared apart, or their sum for a tree whose
  kernel takes no H_shared), beside ``torch.linalg.solve``'s device time;
  the host's time of one call at 11314 taken apart (``host_us``: the
  least of 5 batches of 200 calls of the wrapper and of each of its steps
  alone); then the MU fit and paths A, C, D and F: ms/iter (the least of
  3 fits), and device ms/iter, idle share and launches under
  torch.profiler;
- ``k5block``: K5's block route (SPD) and LU route at chip_smoke phase
  3's shapes, the crossovers those of the redesigned routes on an H100
  (block_max_k 320, LU's 220; the work area in the scratch slot from 3204,
  LU's 1653, timed on the change only; and 239/240, the parent's
  crossover), each tree's kernel on the same systems
  drawn here: rel Frobenius against float64 (1e-3), the LU residual
  (1e-4), two calls bitwise equal, ``ms`` and ``device_ms`` with L2
  flushed, beside the plain version's and ``torch.linalg.solve``'s device
  times; then paths H and A at k = 100 (phase 7c's): the host loop's and a
  cache hit's ms per iteration of the whole solver call;
- ``k5wide``: K5's wide route (33 <= k <= 64) at k in {33, 40, 48, 64}
  on p in {20, 11314, 30000} systems (chip_smoke phase 3's shapes; the
  solver's form, H_rows and H_shared apart, drawn here so that every tree
  solves the same systems): rel Frobenius against float64 (1e-3), two
  calls bitwise equal, H_shared apart bit for bit the whole H, ``ms`` and
  ``device_ms`` with L2 flushed, beside the blocked route's device time
  on the same systems (``pycmf_batched_block_solve``, lu = 0, which takes
  any k in both trees); then path A at k = 40 (phase 7's): the host
  loop's and a cache hit's ms per iteration of the whole solver call;
- ``ties``: K4 at chip_smoke's k = 1 edge shape (30000 x 4097, trials 8)
  on eight seeds: the share of rows whose selected line-search slot agrees
  with the plain version's, and the share on which each of the two matches
  a float64 evaluation, on all rows and on the rows float64 decides by
  more than 2^-22, 2^-20 and 2^-18 of phi (``chip_smoke.decided_rows``).
- ``loops``: the whole fit (the solver's call, L0 included, between two
  syncs) per iteration on the device loop and on the host loop, for MU,
  path A, path F, path A at k = 40, path SD, path S4 and the fp8 MU cell
  (chip_smoke's configurations): the first device fit of a key (the fit
  cache emptied first, where the tree has one; the least of 2), once with
  the data ingested anew just before it (``fresh``: the ingest's own
  temporaries freed, as in a user's fit) and once on data ingested
  earlier, the key's second device fit and a later one (the least of 2),
  and the host loop's (the least of 2), each device fit with its peak
  device memory above what was allocated before it (a fresh ingest's
  included). Ingest is outside ms/iter.
  The code of ``upass``, ``paths``, ``k5k6``, ``k5block``, ``k5wide``,
  ``ties`` and ``loops`` is
  this file's
  (``UPASS``), run against each tree's wrappers, so a tree whose
  chip_smoke predates the redesign is timed the same way.

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
    # the wide route's kernels (u_pass_wide, k > 32; in the parent the
    # mu_fused and newton_fused libraries' slices) at every count of tiles
    "upass": (("mu_fused", "newton_fused", "u_pass_wide"),
              ("Li20E", "Li3E", "u_pass_reduce", "reduce_parts",
               "u_pass_cluster", "wide", "Lb1EE"),
              "upass_ab(check, torch, cs)"),
    "paths": (("mu_fused", "newton_fused", "sigmoid_newton", "batched_solve",
               "mu_update"), ("Li20E", "Li3E"),
              "paths_ab(check, torch, cs)"),
    "ties": (("sigmoid_newton",), ("phi_part",), "ties_ab(check, torch, cs)"),
    # every library the paths launch (fit_loop where the tree has it)
    "loops": (("mu_fused", "newton_fused", "sigmoid_newton", "batched_solve",
               "batched_solve_wide", "mu_update", "csr_spmm", "bell_spmm",
               "fit_loop"), ("Li20E",),
              "loops_ab(check, torch, cs)"),
    # K5's and K6's k = 20 kernels (KP = 20) and K6's per-element one (the
    # parent's only kernel, the k > 32 route since); the fits build every
    # library
    # K5's block and LU routes (the redesign's kernels and the parent's),
    # then paths H and A at k = 100, which build every library they launch
    "k5block": (("mu_fused", "newton_fused", "sigmoid_newton",
                 "batched_solve", "mu_update", "csr_spmm", "bell_spmm",
                 "fit_loop"),
                ("blocked_solve", "block_solve", "lu_solve_warp"),
                "k5block_ab(check, torch, cs)"),
    # K5's wide route (the redesign's kernel and the parent's) and the
    # blocked route, then path A at k = 40, which builds what it launches
    "k5wide": (("mu_fused", "newton_fused", "sigmoid_newton",
                "batched_solve", "batched_solve_wide", "mu_update",
                "fit_loop"),
               ("chol_solve_wide", "blocked_solve_kernelILb0ELi0"),
               "k5wide_ab(check, torch, cs)"),
    "k5k6": (("batched_solve", "mu_update", "mu_fused", "newton_fused",
              "sigmoid_newton", "csr_spmm", "bell_spmm"),
             ("chol_solve_kernelILi20", "mu_update_kernel",
              "mu_update_wide", "mu_update_tile_kernelILi20"),
             "k5k6_ab(check, torch, cs)"),
}
UPASS = """
def upass_ab(check, torch, cs):
    # K1 and K2 at the main shape (X 30000 x 11314): bf16 and f32 X at k =
    # 20 (the narrow route) and at k = 40, 64 and 100 (the wide route), then
    # e4m3 X (the same values rounded to e4m3, as chip_smoke phase 3 rounds
    # them) at k = 20, 40 and 100, each e4m3 call beside its bf16 form on X
    # widened to bf16, which it must equal bit for bit; each call held
    # against its plain version and timed beside it; every output is
    # digested, so chip_ab's main compares the trees' bits (f32 X at k =
    # 20 digested, not compared: its summation order is free to change)
    import hashlib
    import numpy as np
    from pycmf_tpu_torch.ops.kernels import mu_fused, newton_fused
    rng = np.random.RandomState(cs.SEED)
    dev = torch.device("cuda")
    N, M, K = cs.N, cs.M, cs.K
    E4M3 = "float8_e4m3fn"
    WIDE = (40, 64, 100)

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def digest(out):
        h = hashlib.sha256()
        for t in out:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    X32 = f32(rng.rand(N, M))
    ops = {}  # k: (U, V, Vn, Xn as f32), the k = 20 ones drawn first
    for k in (K,) + WIDE:
        U, V, Vn = (f32(abs(rng.randn(N, k))), f32(abs(rng.randn(M, k))),
                    f32(rng.randn(M, k)))
        ops[k] = (U, V, Vn, f32(abs(rng.randn(N, k))) @ Vn.T + (X32 - 0.5))

    def calls(X, Xn, U, V, Vn):
        k = V.shape[1]
        eye = torch.eye(k, device=dev)
        VtV, BtB = V.T @ V, Vn.T @ Vn
        Hinv = torch.cholesky_solve(eye, torch.linalg.cholesky(
            BtB + 0.202 * eye))
        rs = (Xn.float() ** 2).sum(dim=1)
        return (("fused_mu_u_pass", mu_fused.fused_mu_u_pass,
                 mu_fused.fused_mu_u_pass_ref,
                 (X, U, V, VtV, 1e-3, 2e-3, 1e-10), {}),
                ("fused_newton_linear_u_pass",
                 newton_fused.fused_newton_linear_u_pass,
                 newton_fused.fused_newton_linear_u_pass_ref,
                 (Xn, U, Vn, BtB, Hinv, rs, 1e-3, 2e-3),
                 dict(trials=cs.TRIALS, non_negative=True)))

    def held(tag, got, want):
        dev_row = (got[0] - want[0]).abs().amax(dim=1)
        scale = want[0].abs().amax(dim=1).clamp_min(1e-30)
        agree = float((dev_row <= 1e-4 * scale).float().mean())
        e = cs.rel_fro(got[1], want[1])
        check(agree >= 0.999 and e <= 1e-3, f"{tag} rows agreeing "
              f"{agree:.6f}, numV rel Frobenius {e:.3g}")

    def timed(run, got, plain=None, same_bits=True):
        rec = dict(ms=cs.time_ms(run), device_ms=cs.device_ms(run),
                   kernels_us=per_kernel(torch, run),
                   **{"bitwise" if same_bits else "digest": digest(got)})
        if plain is not None:
            rec["plain_ms"] = cs.time_ms(plain)
        return rec

    rec = {}
    for xname in ("bfloat16", "float32"):
        dt = getattr(torch, xname)
        X = X32.to(dt)
        # yardstick: one read of X by PyTorch's own reduction
        rec[f"x_read[{xname}]"] = dict(device_ms=cs.device_ms(
            lambda: X.sum(dtype=torch.float32)))
        for k in (K,) + WIDE:
            U, V, Vn, Xn32 = ops[k]
            Xn = Xn32.to(dt)
            at = "" if k == K else f", k={k}"
            for name, fn, ref, args, kw in calls(X, Xn, U, V, Vn):
                got, again = fn(*args, **kw), fn(*args, **kw)
                held(f"{name}[{xname}{at}]", got, ref(*args, **kw))
                same = all(bool(torch.equal(a, b))
                           for a, b in zip(got, again))
                check(same, f"{name}[{xname}{at}] two calls bitwise equal")
                rec[f"{name}[{xname}{at}]"] = timed(
                    lambda: fn(*args, **kw), got,
                    lambda: ref(*args, **kw),
                    xname != "float32" or k != K)
            del Xn
        del X
    X8 = X32.to(torch.float8_e4m3fn)
    rec[f"x_read[{E4M3}]"] = dict(device_ms=cs.device_ms(
        lambda: X8.view(torch.uint8).sum(dtype=torch.int64)))
    for k in (K, 40, 100):
        Uk, Vk, Vnk, Xn_k = ops[k]
        Xn8 = Xn_k.to(torch.float8_e4m3fn)
        Xb, Xnb = X8.to(torch.bfloat16), Xn8.to(torch.bfloat16)
        wide = calls(Xb, Xnb, Uk, Vk, Vnk)
        for (name, fn, ref, args, kw), (_, _, _, args_b, _) in zip(
                calls(X8, Xn8, Uk, Vk, Vnk), wide):
            got, again = fn(*args, **kw), fn(*args, **kw)
            bf = fn(*args_b, **kw)
            tag = f"{name}[{E4M3}, k={k}]"
            held(tag, got, ref(*args, **kw))
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            eq = all(bool(torch.equal(a, b)) for a, b in zip(got, bf))
            check(same and eq, f"{tag} two calls bitwise equal {same}, "
                  f"equal to the bf16 form on X widened {eq}")
            rec[tag] = timed(lambda: fn(*args, **kw), got,
                             lambda: ref(*args, **kw))
            rec[f"{name}[bf16 form of {E4M3}, k={k}]"] = timed(
                lambda: fn(*args_b, **kw), bf)
        del Xn8, Xb, Xnb
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
    # the host loop: a capture refuses the plain batched solve, and a tree
    # older than the device loop has only the host loop
    common = dict(n_components=cs.K, data_dtype="bfloat16",
                  random_state=cs.SEED, device="cuda", max_iter=20, tol=0.0,
                  eval_every=1, loop="host")
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
def k5k6_ab(check, torch, cs):
    # K6 and K5 at the main path's and the large shapes, the host's time of
    # one call taken apart, and the fits that launch them; the same code
    # against each tree's wrappers (a tree whose K5 takes no H_shared is
    # given H_rows + H_shared, as its solver adds them)
    import hashlib
    import inspect
    import time
    import numpy as np
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels import (_build, batched_solve,
                                             mu_update, policy)
    from pycmf_tpu_torch.utils.datasets import (block_sparse_matrix,
                                                synthetic_20ng)
    dev = torch.device("cuda")
    rng = np.random.RandomState(cs.SEED + 7)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    rec = {}

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    def dev_ms(fn, flush=None, reps=20):
        # chip_smoke.device_ms, with an optional L2 flush before each hold
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            if flush is not None:
                flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    def host_us(fn, n=200, batches=5):
        # host time per call in microseconds, launches enqueued unsynced:
        # the least of `batches` batches of n calls (the host is shared)
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(batches):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            best = min(best, time.perf_counter() - t0)
            torch.cuda.synchronize()
        return 1e6 * best / n

    def host_split(lib, symbol, call, operands, out_shape):
        # the wrapper's call, and each of its steps alone; the C entry's
        # own time with the arguments of a real call (recorded, its output
        # kept alive) and with p = 0 (arguments converted, no launch)
        fn = _build.function(lib, symbol, [])  # resolved by call() first
        seen = []

        def record(*args):
            seen.append(args)
            return fn(*args)
        _build._functions[(lib, symbol)] = record
        try:
            out = call()
        finally:
            _build._functions[(lib, symbol)] = fn
        args = seen[-1]
        zeros = [None if a is ctypes.c_void_p else
                 (0.0 if a is ctypes.c_float else 0) for a in fn.argtypes]
        d = dev.index or 0
        steps = {
            "call": call,
            "c_entry_launch": lambda: (fn(*args), out),
            "on_card": lambda: policy.on_card(*operands),
            "contiguous": lambda: [t.contiguous() for t in operands],
            "data_ptr": lambda: [t.data_ptr() for t in operands],
            "empty": lambda: torch.empty(out_shape, dtype=torch.float32,
                                         device=dev),
            "function": lambda: _build.function(lib, symbol, []),
            "load_and_check": lambda: _build.check(_build.load(lib), 0, ""),
            "device_context_and_stream": lambda: _stream_in_context(torch, d),
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(d),
            "ctypes_call_no_launch": lambda: fn(*zeros),
        }
        return {k: host_us(v) for k, v in steps.items()}

    def digest(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]

    # K6: the bits of every output are compared across the trees (chip_ab's
    # main), so the inputs are drawn on the host
    for p, k in ((20, 20), (11314, 20), (804414, 20), (11314, 40)):
        M, num = f32(np.abs(rng.randn(p, k))), f32(np.abs(rng.randn(p, k)))
        S = f32(np.abs(rng.randn(k, k)) / k)

        def run():
            return mu_update.fused_mu_update(M, S, num, 1e-3, 2e-3, 1e-10)
        out, again = run(), run()
        want = mu_update.fused_mu_update_ref(M.double(), S.double(),
                                             num.double(), 1e-3, 2e-3, 1e-10)
        e = cs.rel_fro(out, want)
        check(e <= 1e-5 and bool(torch.equal(out, again)),
              f"fused_mu_update[{p}x{k}] rel Frobenius {e:.3g} <= 1e-5, "
              f"two calls bitwise equal")
        r = dict(ms=cs.time_ms(run, reps=50), device_ms=dev_ms(run, reps=50),
                 bitwise=digest(out), rel_fro=e)
        if (p, k) == (11314, 20):
            r["host_us"] = host_split("mu_update", "pycmf_mu_update", run,
                                      (M, S, num), (p, k))
        rec[f"fused_mu_update[{p}x{k}]"] = r
    del M, num, out, again, want

    # K5 at k = 20: systems A Aᵀ/k (per row) + a shared SPD part
    takes_shared = "H_shared" in inspect.signature(
        batched_solve.batched_spd_solve).parameters
    k = cs.K
    R = rng.randn(k, k)
    shared = f32(0.21 * np.eye(k) + R @ R.T / k)
    for p in (20, 11314, 30000):
        A = f32(rng.randn(p, k, k))
        Hr = (A @ A.mT) / k
        G = f32(rng.randn(p, k))
        H = Hr + shared

        def solve():
            return batched_solve.batched_spd_solve(H, G)
        if takes_shared:
            def path():
                return batched_solve.batched_spd_solve(Hr, G, shared)
        else:
            def path():
                return batched_solve.batched_spd_solve(Hr + shared, G)
        d, again = solve(), solve()
        want = batched_solve.batched_spd_solve_ref(H.double(), G.double())
        e = cs.rel_fro(d, want)
        check(e <= 1e-4 and bool(torch.equal(d, again)),
              f"batched_spd_solve[p={p}] d rel Frobenius {e:.3g} <= 1e-4, "
              f"two calls bitwise equal")
        r = dict(ms=cs.time_ms(solve, reps=20, flush=flush),
                 device_ms=dev_ms(solve, flush),
                 path_ms=cs.time_ms(path, reps=20, flush=flush),
                 path_device_ms=dev_ms(path, flush), rel_fro=e,
                 library_device_ms=dev_ms(
                     lambda: torch.linalg.solve(H, G[..., None]), flush))
        if p == 11314:
            r["host_us"] = host_split("batched_solve",
                                      "pycmf_batched_spd_solve", solve,
                                      (H, G), (p, k))
        rec[f"batched_spd_solve[p={p}]"] = r
    del A, Hr, H, G, d, again, want

    # the fits that launch them: ms/iter on the host clock (warm-up fit
    # first), then device ms/iter and idle share under torch.profiler
    X, Y = synthetic_20ng(random_state=cs.SEED)
    Xf = block_sparse_matrix(cs.N, cs.M, 0.15, np.random.RandomState(cs.SEED))
    # the host loop, which every tree has: the A/B compares kernels
    common = dict(n_components=cs.K, data_dtype="bfloat16",
                  random_state=cs.SEED, device="cuda", tol=0.0, loop="host")
    mu_kw = dict(solver="mu", max_iter=40, eval_every=10)
    a_kw = dict(solver="newton", y_link="sigmoid", max_iter=20, eval_every=5)
    for label, kw, data in (("MU", mu_kw, X), ("A", a_kw, X),
                            ("C", dict(mu_kw, sparse_mode="csr"), X),
                            ("D", dict(a_kw, sparse_mode="csr"), X),
                            ("F", dict(mu_kw, sparse_mode="csr",
                                       max_iter=20), Xf)):
        def make():
            return CMF(**kw, **common)
        make().set_params(max_iter=2, eval_every=1).fit(data, Y)
        ests = [make().fit(data, Y) for _ in range(3)]
        prof = cs.profile_phase(torch, lambda: make().set_params(
            max_iter=10), data, Y, f"path {label}")
        rec[f"fit {label}"] = dict(
            ms_per_iter=min(1e3 * sum(e.step_times_) / e.n_iter_
                            for e in ests),
            loss=ests[0].reconstruction_err_,
            **{f: prof[f] for f in ("wall_ms_per_iter", "device_ms_per_iter",
                                    "device_idle_share",
                                    "device_launches_per_iter")})
    return rec


def loops_ab(check, torch, cs):
    # whole fits per iteration: a key's first device fit, its second, a
    # later one, and the host loop's, with the device fits' peak memory
    import numpy as np
    from unittest import mock
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.models import cmf as tcmf
    from pycmf_tpu_torch.solvers import common as tcommon
    from pycmf_tpu_torch.utils.datasets import (block_sparse_matrix,
                                                synthetic_20ng)
    clear = getattr(tcommon, "clear_fit_cache", lambda: None)
    X, Y = synthetic_20ng(random_state=cs.SEED)
    Xf = block_sparse_matrix(cs.N, cs.M, 0.15, np.random.RandomState(cs.SEED))
    rs4 = np.random.RandomState(cs.SEED)
    X4, Y4 = np.abs(rs4.randn(20000, 1000)), np.abs(rs4.randn(1000, 200))
    common = dict(n_components=cs.K, data_dtype="bfloat16",
                  random_state=cs.SEED, device="cuda")
    common4 = dict(n_components=cs.K, random_state=cs.SEED, device="cuda")
    mu_kw = dict(solver="mu", max_iter=200, tol=1e-4, eval_every=10)
    a_kw = dict(solver="newton", y_link="sigmoid", max_iter=50, tol=1e-5,
                eval_every=5)
    f_kw = dict(solver="mu", sparse_mode="csr", max_iter=20, tol=0.0,
                eval_every=10)
    sd_kw = dict(a_kw, sparse_mode="csr", sg_sample_ratio=0.25)
    s4_kw = dict(solver="newton", sg_sample_ratio=0.25, tol=1e-5,
                 max_iter=30, eval_every=5)
    common8 = dict(common, data_dtype="fp8")
    real, memo, run_ms = tcmf.as_coupled, {}, []

    def ingest(A, dtype, device, **kw):
        key = (id(A), dtype, str(device), tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = (A, real(A, dtype, device, **kw))
        return memo[key][1]

    run = tcmf.CMF._run

    def whole(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *args)
        torch.cuda.synchronize()
        run_ms.append(1e3 * (time.perf_counter() - t0) / out[3])
        return out

    def fit(make, loop, data, fresh=False):
        if fresh:
            memo.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        make().set_params(loop=loop).fit(*data)
        return run_ms[-1], (torch.cuda.max_memory_allocated() - base) / 1e9

    rec = {}
    with mock.patch.object(tcmf, "as_coupled", ingest), \
            mock.patch.object(tcmf.CMF, "_run", whole):
        for label, kw, cm, data in (
                ("MU", mu_kw, common, (X, Y)),
                ("path A", a_kw, common, (X, Y)),
                ("path F", f_kw, common, (Xf, Y)),
                ("path A k=40", a_kw, dict(common, n_components=40), (X, Y)),
                ("path SD", sd_kw, common, (X, Y)),
                ("path S4", s4_kw, common4, (X4, Y4)),
                ("MU fp8", mu_kw, common8, (X, Y))):
            def make():
                return CMF(**kw, **cm)
            make().set_params(max_iter=2, eval_every=1, loop="host").fit(
                *data)                    # warm-up: loads the libraries
            fresh, first = [], []
            for _ in range(2):
                clear()
                fresh.append(fit(make, "device", data, fresh=True))
            for _ in range(2):
                clear()
                first.append(fit(make, "device", data))
            second = fit(make, "device", data)
            later = [fit(make, "device", data) for _ in range(2)]
            host = [fit(make, "host", data)[0] for _ in range(2)]
            clear()
            memo.clear()
            r = dict(fresh_ms_per_iter=min(t for t, _ in fresh),
                     fresh_peak_gb=max(p for _, p in fresh),
                     first_ms_per_iter=min(t for t, _ in first),
                     first_peak_gb=max(p for _, p in first),
                     second_ms_per_iter=second[0], second_peak_gb=second[1],
                     later_ms_per_iter=min(t for t, _ in later),
                     later_peak_gb=max(p for _, p in later),
                     host_ms_per_iter=min(host),
                     all=dict(fresh=fresh, first=first, second=second,
                              later=later, host=host))
            rec[label] = r
    return rec


def k5block_ab(check, torch, cs):
    # K5's block and LU routes at chip_smoke phase 3's shapes (the change's
    # crossovers on an H100 fixed here, and the systems drawn here, so that
    # every tree solves the same systems), then paths H and A at k = 100:
    # the host loop and the device loop's cache hit
    import numpy as np
    from unittest import mock
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.models import cmf as tcmf
    from pycmf_tpu_torch.ops.kernels import batched_solve
    from pycmf_tpu_torch.solvers import common as tcommon
    from pycmf_tpu_torch.utils.datasets import synthetic_20ng
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    rec = {}

    def dev_ms(fn, reps):
        # chip_smoke.device_ms with the L2 flushed before each hold
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    def systems(rng, p, k, kind):
        # chip_smoke's gn_systems, indefinite_systems and wide_systems
        f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        eye = torch.eye(k, device=dev)
        if kind.startswith("wide"):
            gen = torch.Generator(device=dev).manual_seed(cs.SEED + k)
            A = torch.randn((p, k, k), device=dev, generator=gen) / k ** 0.5
            if kind == "wide spd":
                H, Hs = A @ A.mT + 0.8 * eye, 0.2 * eye
            else:
                order = torch.argsort(torch.rand((p, k), device=dev,
                                                 generator=gen))
                H = torch.gather(A + 3.0 * eye, 1,
                                 order[:, :, None].expand(p, k, k))
                Hs = torch.zeros_like(eye)
            G = torch.randn((p, k), device=dev, generator=gen)
            return H.contiguous(), Hs, G
        if kind == "indefinite":
            Q = torch.linalg.qr(f32(rng.randn(p, k, k)))[0]
            lam = (1.0 + 2.0 * rng.rand(p, k)) * np.where(
                rng.rand(p, k) < 0.5, -1.0, 1.0)
            lam[:, 0] = -np.abs(lam[:, 0])
            H = (Q * f32(lam)[:, None, :]) @ Q.mT - 0.2 * eye
            return H.contiguous(), 0.2 * eye, f32(rng.randn(p, k))
        B, Mf = f32(0.3 * rng.randn(2048, k)), f32(0.3 * rng.randn(p, k))
        P = torch.sigmoid(Mf @ B.T)
        BB = (B[:, :, None] * B[:, None, :]).reshape(2048, k * k)
        Hr = torch.empty((p, k * k), device=dev)
        for i in range(0, p, 256):
            Hr[i:i + 256] = ((P[i:i + 256] * (1 - P[i:i + 256])) ** 2) @ BB
        return Hr.view(p, k, k), 1.2 * eye, f32(rng.randn(p, k))

    M = cs.M
    shapes = [("block", M, 65, "spd"), ("block", M, 100, "spd"),
              ("block", M, 128, "spd"), ("block", 20, 100, "spd")]
    shapes += [("block", 2048, k, "spd") for k in (239, 240, 320, 321)]
    shapes += [("block", 512, 444, "spd")]
    shapes += [("lu", M, k, kind) for k in (20, 40, 100)
               for kind in ("spd", "indefinite")]
    shapes += [("lu", 20, 20, "spd"), ("lu", 2048, 221, "indefinite"),
               ("lu", 512, 385, "indefinite")]
    if hasattr(batched_solve, "SLOT_ALL"):
        # where the work area leaves shared memory (the parent's scratch
        # route, a column at a time, takes seconds a call there: not timed)
        shapes += [("block", 33, 3204, "wide spd"),
                   ("lu", 33, 1653, "wide indefinite")]
    for name, p, k, kind in shapes:
        rng = np.random.RandomState(cs.SEED + 8 + 7 * k + p)
        Hr, Hs, G = systems(rng, p, k, kind)
        H = Hr + Hs
        lu = name == "lu"
        solve = (batched_solve.batched_lu_solve if lu
                 else batched_solve.batched_spd_solve)
        ref = (batched_solve.batched_lu_solve_ref if lu
               else batched_solve.batched_spd_solve_ref)

        def kern():
            return solve(Hr, G, Hs)
        d, again = kern(), kern()
        want = ref(H.double(), G.double())
        e = cs.rel_fro(d, want)
        tag = f"{name} {p}x{k} {kind}"
        r = dict(rel_fro_f64=e)
        ok = e <= 1e-3 and bool(torch.equal(d, again)) and bool(
            torch.isfinite(d).all())
        if lu:
            res = (H.double() @ d.double()[..., None])[..., 0] - G.double()
            r["residual"] = float(res.norm() / G.double().norm())
            ok &= r["residual"] <= 1e-4
        check(ok, f"{tag}: rel Frobenius {e:.3g} against float64, two calls "
              f"bitwise equal, finite, residual {r.get('residual')}")
        reps = 10 if k <= 128 else 3 if k <= 1024 else 1
        r["ms"] = cs.time_ms(kern, reps=reps, flush=flush)
        r["device_ms"] = dev_ms(kern, reps)
        r["plain_device_ms"] = dev_ms(lambda: ref(Hr, G, Hs), min(reps, 3))
        r["library_device_ms"] = dev_ms(
            lambda: torch.linalg.solve(H, G[..., None]), min(reps, 3))
        rec[tag] = r
        del Hr, Hs, G, H, d, again, want
        torch.cuda.empty_cache()

    # paths H and A at k = 100 (chip_smoke phase 7c's): ms per iteration of
    # the whole solver call, the host loop (least of 2) and a cache hit (the
    # key's third device fit on, least of 2)
    X, Y = synthetic_20ng(random_state=cs.SEED)
    common = dict(n_components=cs.K, data_dtype="bfloat16",
                  random_state=cs.SEED, device="cuda")
    a_kw = dict(solver="newton", y_link="sigmoid", max_iter=50, tol=1e-5,
                eval_every=5)
    clear = getattr(tcommon, "clear_fit_cache", lambda: None)
    run, run_ms = tcmf.CMF._run, []

    def whole(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *args)
        torch.cuda.synchronize()
        run_ms.append((1e3 * (time.perf_counter() - t0) / out[3], out[3]))
        return out
    with mock.patch.object(tcmf.CMF, "_run", whole):
        for label, kw, cm in (
                ("path H", dict(a_kw, hessian_form="full"), common),
                ("path A k=100", a_kw, dict(common, n_components=100))):
            def make(loop):
                return CMF(**kw, **cm, loop=loop)
            make("host").set_params(max_iter=2, eval_every=1).fit(X, Y)
            host = [(make("host").fit(X, Y), run_ms[-1])[1]
                    for _ in range(2)]
            clear()
            fits = [(make("device").fit(X, Y), run_ms[-1])[1]
                    for _ in range(4)]
            clear()
            rec[label] = dict(host_ms_per_iter=min(t for t, _ in host),
                              hit_ms_per_iter=min(t for t, _ in fits[2:]),
                              first_ms_per_iter=fits[0][0],
                              second_ms_per_iter=fits[1][0],
                              n_iter=[n for _, n in host + fits])
    return rec


def k5wide_ab(check, torch, cs):
    # K5's wide route at chip_smoke phase 3's shapes on systems drawn here
    # (every tree solves the same), the blocked route beside it; then path
    # A at k = 40: the host loop and the device loop's cache hit
    import ctypes
    import numpy as np
    from unittest import mock
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.models import cmf as tcmf
    from pycmf_tpu_torch.ops.kernels import _build, batched_solve as bs
    from pycmf_tpu_torch.solvers import common as tcommon
    from pycmf_tpu_torch.utils.datasets import synthetic_20ng
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    block = _build.function(
        "batched_solve", "pycmf_batched_block_solve",
        (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2
        + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    rec = {}

    def dev_ms(fn, reps):
        # chip_smoke.device_ms with the L2 flushed before each hold
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            flush()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    def blocked(Hr, G, Hs):
        # the blocked SPD route, one CTA per system in shared memory
        p, k = G.shape
        out = torch.empty_like(G)
        rc = block(Hr.data_ptr(), Hs.data_ptr(), G.data_ptr(), p, k, 0,
                   out.data_ptr(), None, 0, bs.block_threads(k, False),
                   4 * bs.block_smem_floats(k, False), 0,
                   torch._C._cuda_getCurrentRawStream(0))
        if rc:
            raise RuntimeError(f"the blocked route, k = {k}: CUDA error {rc}")
        return out

    for k in (33, 40, 48, 64):
        rng = np.random.RandomState(cs.SEED + 9 * k)
        B = torch.from_numpy((0.3 * rng.randn(2048, k)).astype(np.float32)) \
            .to(dev)
        BB = (B[:, :, None] * B[:, None, :]).reshape(2048, k * k)
        Hs = 1.2 * torch.eye(k, device=dev)
        for p in (20, cs.M, cs.N):
            Mf = torch.from_numpy(
                (0.3 * rng.randn(p, k)).astype(np.float32)).to(dev)
            P = torch.sigmoid(Mf @ B.T)
            Hr = torch.empty((p, k * k), device=dev)
            for i in range(0, p, 4096):
                Hr[i:i + 4096] = ((P[i:i + 4096] * (1 - P[i:i + 4096])) ** 2) \
                    @ BB
            Hr = Hr.view(p, k, k)
            G = torch.from_numpy(rng.randn(p, k).astype(np.float32)).to(dev)
            H = Hr + Hs
            del Mf, P

            def kern():
                return bs.batched_spd_solve(Hr, G, Hs)
            d, again = kern(), kern()
            whole = bs.batched_spd_solve(H, G)
            want = bs.batched_spd_solve_ref(H.double(), G.double())
            e = cs.rel_fro(d, want)
            ok = (e <= 1e-3 and bool(torch.equal(d, again))
                  and bool(torch.equal(d, whole)))
            tag = f"wide {p}x{k}"
            check(ok, f"{tag}: rel Frobenius {e:.3g} against float64, two "
                  f"calls bitwise equal, H_shared apart equal to the whole")
            reps = 20 if p > 20 else 50
            r = dict(rel_fro_f64=e)
            r["ms"] = cs.time_ms(kern, reps=reps, flush=flush)
            r["device_ms"] = dev_ms(kern, reps)
            r["whole_device_ms"] = dev_ms(
                lambda: bs.batched_spd_solve(H, G), reps)
            r["blocked_device_ms"] = dev_ms(lambda: blocked(Hr, G, Hs), reps)
            r["plain_device_ms"] = dev_ms(
                lambda: bs.batched_spd_solve_ref(Hr, G, Hs), 3)
            r["library_device_ms"] = dev_ms(
                lambda: torch.linalg.solve(H, G[..., None]), 3)
            rec[tag] = r
            del Hr, G, H, d, again, whole, want
            torch.cuda.empty_cache()

    # path A at k = 40 (chip_smoke phase 7's): ms per iteration of the whole
    # solver call, the host loop (least of 2) and a cache hit (the key's
    # third device fit on, least of 2)
    X, Y = synthetic_20ng(random_state=cs.SEED)
    kw = dict(solver="newton", y_link="sigmoid", max_iter=50, tol=1e-5,
              eval_every=5, n_components=40, data_dtype="bfloat16",
              random_state=cs.SEED, device="cuda")
    clear = getattr(tcommon, "clear_fit_cache", lambda: None)
    run, run_ms = tcmf.CMF._run, []

    def whole_fit(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, *args)
        torch.cuda.synchronize()
        run_ms.append((1e3 * (time.perf_counter() - t0) / out[3], out[3]))
        return out
    with mock.patch.object(tcmf.CMF, "_run", whole_fit):
        def make(loop):
            return CMF(**kw, loop=loop)
        make("host").set_params(max_iter=2, eval_every=1).fit(X, Y)
        host = [(make("host").fit(X, Y), run_ms[-1])[1] for _ in range(2)]
        clear()
        fits = [(make("device").fit(X, Y), run_ms[-1])[1] for _ in range(4)]
        clear()
        rec["path A k=40"] = dict(
            host_ms_per_iter=min(t for t, _ in host),
            hit_ms_per_iter=min(t for t, _ in fits[2:]),
            n_iter=[n for _, n in host + fits])
    return rec


def _stream_in_context(torch, d):
    with torch.cuda.device(d):
        return torch.cuda.current_stream().cuda_stream


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
import os, subprocess
from pycmf_tpu_torch.ops.kernels import _build
_build.NAMES = tuple(n for n in {names!r}  # those the tree has
                     if (_build.CSRC / (n + '.cu')).exists())
_build.build_all()
dump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
for name in _build.NAMES:
    entry = ""
    for line in _build.build_log(name).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif (("registers" in line or "spill" in line)
              and any(tag in entry for tag in {tags!r})):
            print(name, entry, line.strip())
    # machine instructions per reported kernel (cuobjdump -sass)
    if not os.path.exists(dump):
        continue
    sass = subprocess.run([dump, "-sass", str(_build._library_path(name))],
                          capture_output=True, text=True).stdout
    entry = None
    count = {{}}
    for line in sass.splitlines():
        if "Function :" in line:
            entry = line.split(":", 1)[1].strip()
            count[entry] = 0
        elif entry and line.strip().startswith("/*") and ";" in line:
            count[entry] += 1
    for entry, n in count.items():
        if any(tag in entry for tag in {tags!r}):
            print(name, entry, "SASS instructions", n)
"""
RUN = """
import ctypes, json, time, torch, chip_smoke as cs
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
    bits = {}
    for tree in trees + trees[::-1]:
        r = subprocess.run([sys.executable, "-c",
                            RUN.format(call=call, upass=UPASS)],
                           cwd=tree, capture_output=True, text=True)
        rec = (json.loads(r.stdout.strip().splitlines()[-1])
               if r.returncode == 0 else {"error": r.stderr[-3000:]})
        ok &= r.returncode == 0 and not rec.get("failed")
        print(json.dumps({"tree": tree, "phase": phase, **rec}), flush=True)
        for key, v in rec.get("kernels", {}).items():
            if isinstance(v, dict) and "bitwise" in v:
                bits.setdefault(key, set()).add(v["bitwise"])
    if bits:  # outputs digested by every run must agree across the trees
        same = {key: len(d) == 1 for key, d in bits.items()}
        ok &= all(same.values())
        print(json.dumps({"bitwise_equal_across_trees": same}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
