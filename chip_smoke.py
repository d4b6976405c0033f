#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pycmf_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ok line):
 1. device: the card's name and power limit (nvidia-smi);
 2. build: the eleven CUDA kernel libraries (the eleven kernels of the
    TPU's: K1 and K2 have a wide route for k > 32, u_pass_wide; K5 has a
    wide route for 32 < k <= 64, a block route for k > 64 and an LU route
    for the full Hessian form; and fit_loop, the device loop's stop rule
    and fit graph, and threefry, the sampled fits' draws), from
    pycmf_tpu_torch/csrc, each nvcc started at once;
 3. each kernel against its plain PyTorch version on the same inputs, with
    CUDA-event times and the card's lower bound for the same work:
    K1, K2 at X 30000 x 11314 (bf16 and f32: the f32 form's cluster route,
    its clusters against the card's resident count), k = 20, and on the
    wide route at k = 40 and 100 (bf16 and f32, X read once per sweep),
    and at the edges (n in {1, 17, 30000}, m in {1, 15, 4097, 11314}, k in
    {1, 7, 20, 32, 33, 64, 100, 128, 129, 200}, n_valid < n, trials 0 and 8,
    non_negative both ways;
    f32 X at the m on both sides of the cluster route's crossover); K3,
    K4 at the main path's Z shape (Y^T 20 x 11314, bf16) and at the dense
    sigmoid-X shapes (30000 x 11314, bf16 and f32, and its transpose), and
    at the edges (n in {1, 17, 20, 30000}, q in {1, 15, 4097, 11314}, k in
    {1, 7, 20, 32, 33, 64, 100}, bf16 and f32, trials 0 and 8,
    non_negative both ways); K5 at 11314 and 30000 systems of 20 x 20,
    and its wide route at k in {33, 40, 48, 64} on 20, 11314 and 30000
    systems, whole and with H_shared apart, beside torch.linalg.solve and
    the blocked route on the same systems; K5's block route at k in {65, 100,
    128} (11314 systems) and at the largest k kept in shared memory and
    one above (2048 systems, a global scratch), its LU route at k in {20,
    40, 100} on SPD and indefinite systems (relative Frobenius 1e-3 and
    residual 1e-4), a singular system's row NaN; K5 and
    K6 at the edges of their tiles (solve_update_edges); csr_spmm (X V and
    X^T U) and csr_rowdots on the 20NG surrogate's CSR and an
    RCV1-v2-shaped one (47236 x 804414, 60M nonzeros), beside
    torch.sparse.mm; fused_mu_update at 11314 x 20 and 804414 x 20;
    bell_spmm on a block-structured 30000 x 11314 X (51M nonzeros) and
    on its transpose, beside a BSR torch.sparse.mm, and the
    fill at which it and csr_spmm take equal device time; edge cases at small
    shapes (k up to 100), each kernel's output and scratch NaN-filled
    before one call; the fp8 forms of K1 and K2 (e4m3 X 30000 x 11314, k =
    20 and 40) and of K3 and K4 (the dense sigmoid-X shape and its
    transpose), each against its plain version and against its own bf16
    form on X widened to bf16 (bit for bit), timed beside that bf16 form,
    with the bound at 1 byte per element, and at the edges (n in {1, 17,
    20}, m or q in {1, 15, 17, 4097, 11314}, X at odd byte offsets);
    fit_loop's stop_rule_kernel against stop_rule_ref on crafted loss
    sequences (NaN, +-inf, L0 <= 0, equal losses, ties at tol), bit for
    bit, and timed eagerly and per block inside a fit graph; threefry's
    kernel against threefry2x32_ref bit for bit (the Random123 vectors, n
    in {1, 2, 4097, 30000, 804414} in each form), the card's
    choice_without_replacement against digests computed with JAX, a graph
    of two sampled steps' draws (no node a conditional body refuses, its
    replays drawing from the device counter), each timed;
 4. MU fit of the 20NG-shaped surrogate, bf16 X, through the estimator:
    kernel launches, and the exact (float64) loss non-increasing along the
    fit, replayed as warm-started segments;
 5. the same for a Newton fit with linear links;
 6. path A, bench.py's Newton cell: linear X, sigmoid Y (K2, K3, K4, K5),
    and K5 handed H_shared apart on every call;
 7. path B, dense sigmoid X and Y on the binarised surrogate (K3, K4, K5),
    its phi eval loss against an exact float64 loss taken on the card;
    path C, MU on the surrogate kept CSR (sparse_mode='csr': csr_spmm,
    fused_mu_update, csr_rowdots); path D, bench's Newton cell on the CSR
    X; path F, MU on the block-structured X through BlockEll (bell_spmm);
    the MU cell and path A at n_components=40 (k > 32, use_pallas left at
    its default; path A's per-row solves on K5's wide route, on the device
    loop); path S, stochastic minibatch Newton (path A with
    sg_sample_ratio=0.25: K5 on every per-row solve, no fused pass);
    path S4, BASELINE.json config #4 (tall |N(0,1)| X 20000 x 1000, Y
    1000 x 200, f32, sg_sample_ratio=0.25); path SD (path D with
    sg_sample_ratio=0.25: csr_spmm on B·mask, masked row norms); path H
    (path A with hessian_form='full': K5's LU route, the device loop;
    with use_pallas=False loop='device' raises naming ROADMAP C3); path A
    at k = 100 (K5's block route, the device loop); each sampled fit's
    exact float64 loss at its end; the chunked layout
    (sparse_mode='chunked'): path K (the MU cell, 3 chunks: K1 per chunk),
    KA (path A: K2 per chunk), KB (path B with X and Y chunked: K3, K5, K4
    per chunk of X), KS (KA sampled at 0.25), each with its peak device
    memory; path KR (the RCV1 surrogate as doc x term, 804414 x 47236
    bf16, MU, 10 iterations, chunked against CSR: ms/iter, device ms/iter,
    idle share, the layout's padding) and path KRS (its binarised form,
    sigmoid X under 'auto', which must resolve to the chunked layout,
    Newton, 2 iterations: s/iter, launches, peak memory); fp8 storage
    (data_dtype='fp8'): the ingest (the e4m3 bytes against the host's
    conversion, the peak of its float32 buffer), 'csr' and 'chunked'
    refused with the reference's ValueError, and the MU cell, path A and
    path B as fit_phase runs them (K1, K2, K3/K4's fp8 forms counted
    apart, the bf16 forms of K1 and K2 launched no time, the exact loss on
    the quantized X, peak device memory); the MU cell and path A with the
    estimator's default dtype (dtype and data_dtype unset: X float32, K1
    and K2 on their f32 form's cluster route, once per iteration, the
    exact float64 loss of the final factors); then MU, Newton
    linear, paths A to D, F, S and SD, path A at k = 40 and the
    default-dtype MU cell and path A under
    torch.profiler
    (device time by kernel, idle share, launches per iteration, and on
    path F bell_spmm's share);
 7c. the device loop (loop='device': a key's first fit replays a graph
    of one eval block per block; its second builds the cache's one entry;
    every later fit of the key is one launch of a CUDA graph, the eval
    block in a conditional while node, a sampled fit's too, its draws
    keyed on a device counter; what loop='auto' runs on the card, so
    phases 4-7 run it too) against the host loop on MU,
    Newton linear and paths A, C, D, F, S, S4 and SD and the MU cell and
    path A at k = 40, and paths H, A at k = 100, K, KA, KB, KS, the
    fp8 MU cell, path A and path B, and the default-dtype (f32) MU cell and
    path A, each after an untimed host fit, from
    an emptied fit cache: the key's first device fit (no entry left), the
    fit that builds the entry (its copies, captures and graph build timed
    apart), then two fits per loop, each device fit a cache hit (no
    capture, no eager block; one graph launch): the same n_iter_ and eval points, bit for bit (losses within
    1e-6 relative and factors within 1e-5 also printed), equal launch
    counts but fit_loop's (one per eval block, and a fit graph's gates),
    the first hit's factors unchanged by the second and none of them a
    cache buffer; on MU, path A and path S a fit with another alpha
    misses; each loop's ms/iter (least of 2 fits, the device loop's on a
    hit), the first and the building fit's ms/iter, each device fit's
    peak memory above its start, the cache entry's bytes, pool bytes and
    graph nodes, device ms/iter, idle share, host launch calls and graph
    launches per fit; two fits of paths S, S4, SD and KS each with one
    random_state equal, with another not;
 R. the sharded fits (n_shards, parallel/sharded.py, parallel/grid.py)
    at the main path's full width: R1, run_sharded on a one-rank NCCL
    group in this process, MU and path A against the single-device
    host-loop fit of the same inputs (n_iter, the loss history and the
    factors; bit for bit expected, 1e-6 checked), with launch counts,
    ms/iter in turns beside the
    single-device fit, a one-rank gloo group and the NCCL fit without its
    collective, the host's time in each all-reduce call, and the
    all-reduce's share of each iteration (CUDA events around it); R2,
    CMF(n_shards=2) in two spawned gloo ranks on the one card (NCCL refuses
    two ranks on one device): MU, path A, path C, path F and path B, each
    run to its phase-7 fit's n_iter (its loop at tol -inf) and held
    within 1e-4 of that fit's exact float64 loss, both ranks'
    losses equal and each rank's launches counted, and which gloo
    collectives take CUDA tensors; R1c, run_sharded(layout='cols') on a
    one-rank NCCL group, MU and path A run to the single-device host
    fit's n_iter (tol 0) and held to it by the exact float64 loss (1e-4),
    with launch counts, ms/iter in turns beside the single-device fit,
    the all-reduce's calls, bytes and device ms; R2c,
    CMF(n_shards=2, shard_layout='cols') in two gloo ranks on the card:
    MU, path A, path C, path F and path B as R2 (K6, K3/K4, K5, csr_spmm
    and bell_spmm launched by each rank); R1g, run_grid(grid=(1, 1)) on a
    one-rank NCCL group (its two axis subgroups made under NCCL; an axis
    of one rank makes no collective, the world's calls remain): MU, path
    A and path F (a BlockEll cell) to the single-device fit's n_iter (tol
    0), held by the exact float64 loss (1e-5), with launch counts, ms/iter
    (MU and A in turns beside the single device, least of 3; F least of
    two grid fits beside its phase-7 fit) and the all-reduce's calls,
    bytes and device ms per mesh axis; R2g, CMF(n_shards=(2, 2),
    shard_layout='grid') in four gloo ranks on the card: MU, path A, path
    C (CSR cells) and path B (K3/K4 on both axes) as R2; R1 fp8,
    run_sharded (rows) with e4m3 X on a one-rank NCCL group: the MU cell
    and path A bit for bit with the single-device fp8 host fits (every
    eval loss and the factors), K1's and K2's e4m3 forms launched and
    their bf16 forms not; R2 fp8, the fp8 MU
    cell in two gloo ranks, rows and grid (2, 1), within 1e-4 of the
    single-device fp8 fit's exact loss; R1 S, R1 K and R1 KA, run_sharded
    (rows) on a one-rank NCCL group with path S (sampled: the sharded
    fit's draws recorded and replayed into the single-device fit), path K
    and path KA (chunked blocks): n_iter and the factors bit for bit with
    the single-device host fit, K's and KA's eval losses too, S's within
    R1S_LOSS_BAR (the sharded full loss takes the reference's
    factor-precision inner product, the single device the bf16 product),
    K1 (K) and K2 (KA) launched per chunk as on the single device, K5 on
    S; R1c K and R1g K, path K in the cols layout and on the (1, 1) grid
    to its n_iter (tol 0), exact-loss gap 1e-5; R2 S, path S in the R2
    spawn, its ranks drawing the reference's per-rank columns, within the
    range of path S's single-device exact losses over R2S_SEEDS keys from
    the same initial factors, widened by R2S_BAR, and below the initial
    factors'; R2g K,
    path K on the (2, 2) grid in the R2g spawn; every R2-family rank's
    factors equal bit for bit (by digest); R1d, the device loop under
    shards (loop='device': each block's all-reduces captured into the
    fit's CUDA graphs) on a one-rank NCCL group: rows MU, rows path A,
    cols path A, grid (1, 1) path A, rows path S and rows path K, each
    from an emptied fit cache as the key's first fit, its second (builds
    the cache entry) and two hits (one launch of the fit graph, path S's
    too; a replay per block only when the captured block holds a node type
    a conditional body refuses, named), every one bit for bit with the
    host loop of the same sharded call (n_iter, losses, U, V, Z) with
    equal COMM calls and bytes and, for the hits, equal kernel launches
    but fit_loop's; ms/iter of each, the hit's host launch calls and
    graph launches (torch.profiler), and the hit with dist.all_reduce
    patched out of its captures; every kernel's launches in the kernels
    line include these fits';
 8. kernel path against plain path on the card (the plain fits on the host
    loop: a capture refuses the plain batched solve): after 20 iterations,
    checked to 1e-3 on paths B, C, D and F and printed for MU, Newton
    linear and path A, whose dense bf16 trajectories are chaotic; those,
    and the k = 40 fits, paths S and SD (both paths of a step making
    the same draws) and the chunked paths K and KA, step by step from
    shared factors (step_agreement: factors 1e-4 (MU) or 1e-3 (Newton),
    exact loss 1e-6); one step of path K against one dense MU step on the
    same data (factors 1e-4); K5's block route on path A's own systems at
    k = 100, call by call against its plain version (1e-3); the fp8 MU
    cell and path A step by step against their plain versions (5 steps),
    and each fp8 path (MU 20, A 20, B 10 iterations) against the bf16 fit
    of the quantized X from the same factors, bit for bit, with the
    fold-in of 1000 rows; and the final
    losses of MU, path A, path C and path D, and the exact losses of the
    default-dtype MU cell and path A, against the NumPy baselines (2%
    guard);
 9. transform of 1000 new rows, dense (MU), CSR (path C) and fp8 (MU);
    the estimator's utilities on the card: print_topic_terms of the MU
    fit, a save_model/load_model(device='cuda') round trip whose transform
    equals the fitted model's bit for bit, and utils.profiling.trace
    around one fit, whose trace names the port's kernels.
Each fit is run with the launch counts set to 0 just before it and read
just after. Standard output ends with the fits' record, the card's name and
power limit, the kernels' JSON record and, last, {"ok": true, ...}.
Details go to standard error. ``python3 -m pycmf_tpu_torch.chip_ab``
times phase 3's K3, K4 and K5, its sparse kernels, or K1 and K2, in
several checkouts.
"""
from __future__ import annotations

import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from contextlib import ExitStack, contextmanager
from unittest import mock

N, M, K = 30000, 11314, 20
SEED = 0
QUALITY_BAR = 0.02   # bench.py's equal-final-loss guard
TRIALS = 8
# H100 SXM data sheet rates
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
SMS = 132
SFU_PER_SM_CLOCK = 16   # MUFU operations (ex2, rcp) per SM per clock
# K4's line-search slots: a row whose float64 phi differences that decide
# its slot are within TIE_REL of phi is a tie at float32 precision (phi
# itself is rounded to 2^-24; its float32 sums over q carry several such
# roundings); at least MIN_DECIDED of the rows must be decided
TIE_REL, MIN_DECIDED = 2.0 ** -20, 0.9


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line on standard error, after the seconds since the start."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", file=sys.stderr,
          flush=True)


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> bool:
        log(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)
        return ok


def time_ms(fn, warmup: int = 2, reps: int = 10, flush=None) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up; flush() (not
    timed) runs before each timed call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 10, flush=None) -> float:
    """Median device time of fn() in ms: the card is held busy (about 1 ms
    of torch.cuda._sleep) while the host enqueues the events and fn's
    launches, so the events bracket the device's work alone; flush() (not
    timed) is enqueued before each hold."""
    import torch

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
    times.sort()
    return times[len(times) // 2]


def bound(nbytes: float, flops: float, peak: float) -> tuple:
    """(least ms for the work on this card, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def spd_bytes(p: int, k: int) -> float:
    """Least bytes of p SPD solves of k x k from a row-major (p, k, k) H:
    an unpivoted Cholesky reads each system's lower triangle alone, in the
    32-byte sectors its rows touch (the rows' offsets within a sector recur
    every 8 systems), reads g once and writes d once."""
    import numpy as np

    def sectors(n):
        i = np.arange(k)
        start = 4 * (np.arange(n)[:, None] * k * k + i * k).ravel()
        first = start // 32
        last = (start + 4 * np.tile(i + 1, n) - 1) // 32
        # rows in memory order: a row shares at most its first sector with
        # the row before it
        return int((last - first + 1).sum() - (first[1:] == last[:-1]).sum())
    return 32.0 * ((p // 8) * sectors(8) + sectors(p % 8)) + 8.0 * p * k


def rel_fro(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm())


def factor_gap(got, want) -> float:
    """The largest ‖a − b‖ / ‖b‖ over pairs of host factors, in float64:
    0 for a pair both all zero (a step can zero Z of a sigmoid Y under
    non-negative factors), inf for a zero b beside a nonzero a, and NaN
    when a factor holds a NaN, so that a bar compared with it fails."""
    import numpy as np

    gaps = []
    for a, b in zip(got, want):
        d, n = np.linalg.norm(a - b), np.linalg.norm(b)
        gaps.append(d / n if n else (0.0 if d == 0 else math.inf))
    return float(np.max(gaps))


def nan_filled(fn):
    """fn() with every floating-point torch.empty (outputs and scratch
    of the wrappers) filled with NaN: a row the kernel leaves unwritten
    shows."""
    import torch

    real = torch.empty

    def nan_empty(*args, **kw):
        t = real(*args, **kw)
        return t.fill_(math.nan) if t.is_floating_point() else t

    with mock.patch.object(torch, "empty", nan_empty):
        return fn()


def selected_slot(phis):
    """Per row: the first slot t >= 1 with phi[t] < phi[0], else 0."""
    import torch

    if phis.shape[1] == 1:  # trials = 0: slot 0 only
        return torch.zeros(phis.shape[0], dtype=torch.long,
                           device=phis.device)
    acc = phis[:, 1:] < phis[:, :1]
    first = acc.to(torch.int8).argmax(dim=1) + 1
    return torch.where(acc.any(dim=1), first, torch.zeros_like(first))


def slot_agreement(a, b, rows=None) -> float:
    """Share of rows (of those `rows` marks, if given) whose selected
    line-search slot agrees."""
    same = selected_slot(a) == selected_slot(b)
    if rows is not None:
        same = same[rows]
    return float(same.float().mean()) if same.numel() else 1.0


def decided_rows(phi64, rel):
    """Rows whose line-search slot float64 decides by more than `rel` of
    their phi: every comparison phi[t] < phi[0] that selects the slot (t up
    to the selected slot, or every t where none is selected) has a margin
    above rel |phi[0]|. Elsewhere the choice is a tie at that precision."""
    import torch

    diff = (phi64[:, 1:] - phi64[:, :1]).abs()
    if diff.shape[1] == 0:
        return torch.ones(phi64.shape[0], dtype=torch.bool,
                          device=phi64.device)
    sel = selected_slot(phi64)
    t = torch.arange(1, diff.shape[1] + 1, device=phi64.device)
    deciding = (t[None, :] <= sel[:, None]) | (sel[:, None] == 0)
    margin = torch.where(deciding, diff, torch.inf).amin(dim=1)
    return margin > rel * phi64[:, 0].abs()


def upass_inputs(torch, rng, n, m, k, dev, signed=False):
    """K1/K2 operands from one seed: MU's X, U, V and Newton's X = U_t V_nᵀ
    + noise with zero-mean V_n, a well-conditioned least-squares problem
    per row. (With all-positive V the step U − d cancels to a few percent
    of |U|, and both versions' f32 rounding, amplified by cond(VᵀV),
    differs by more than 1e-4 of the result; that would measure the data,
    not the kernel.)"""
    import numpy as np

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    X = f32(rng.rand(n, m))
    U = f32(rng.randn(n, k) if signed else np.abs(rng.randn(n, k)))
    V = f32(np.abs(rng.randn(m, k)))
    Vn = f32(rng.randn(m, k))
    Xn = f32(np.abs(rng.randn(n, k))) @ Vn.T + (X - 0.5)
    return X, U, V, Vn, Xn


def upass_mats(torch, V, Vn, l2, pert):
    k = V.shape[1]
    eye = torch.eye(k, device=V.device)
    BtB = Vn.T @ Vn
    L = torch.linalg.cholesky(BtB + (l2 + pert) * eye)
    return V.T @ V, BtB, torch.cholesky_solve(eye, L)


def newton_rows_agree(got, want) -> float:
    """Share of rows whose largest deviation is within 1e-4 of the row's
    largest entry (a line-search tie may flip a few rows)."""
    row_dev = (got - want).abs().amax(dim=1)
    row_scale = want.abs().amax(dim=1).clamp_min(1e-30)
    return float((row_dev <= 1e-4 * row_scale).float().mean())


def own_products(torch, mu_fused, X, got):
    """Relative Frobenius errors of numV and gramU against the plain
    products Xᵀ round(U_new) and U_newᵀ U_new of the kernel's own U_new,
    rounded to X's operand dtype (bf16 for e4m3 X; 0 where both are 0)."""
    from pycmf_tpu_torch.ops.matmul import operand_dtype

    unew = got[0]
    want = (mu_fused._acc_matmul(X.mT, unew.to(operand_dtype(X.dtype)),
                                 torch.float32), unew.mT @ unew)
    return tuple(0.0 if not bool(w.any()) and not bool(g.any())
                 else rel_fro(g, w) for g, w in zip(got[1:], want))


def u_pass_edges(check, torch, mu_fused, newton_fused):
    """K1, K2 at the edges: n in {1, 17, 30000}, m in {1, 15, 4097, 11314},
    k in {1, 7, 20, 32, 33, 64, 100, 128, 129, 200} (k > 32: the wide
    route; 128 its widest single slice, 129 and 200 two slices of 128; at
    200 K2's epilogue reads its k x k matrices from device memory, its
    instantiation with generic pointers), bf16 and f32
    X, and f32 X on both sides of the cluster route's crossover in m
    (12288 at k = 1 and 7, 11520 at 20, 9984 at 32; n of 30000 at k = 20
    and 32), MU with n_valid < n, Newton with
    trials 0 and TRIALS, non_negative both ways; every output and the
    workspace NaN-filled before the call, a second call bitwise equal, the
    tolerances of the main shape. U_new is held against the plain
    version; numV and gramU against the plain products of the kernel's own
    U_new (at n = 1 a U_new entry a few ulps off that rounds to the other
    bf16 neighbour moves numV by 4e-3 of its column: the rounding, not the
    product). K2's rows: >= 0.999 agreeing with the plain version, or, where
    they do not, agreeing with a float64 evaluation of the plain version on
    no fewer rows than the plain float32 version does: with
    m < k (m = 1, 15 at k = 33..100) each row's damped system has a rank-m
    BᵀB, U_new cancels most of U, and f32 rounding in any summation order
    moves more than 1e-4 of some rows; the second clause holds the kernel
    to the plain version's own accuracy there (which 3xTF32's ~2^-22 per
    product did not reach with f32 X: the wide route takes six TF32
    products there, u_pass_common.cuh: xv_stage_mma_6x)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 4)
    l1, l2, eps, pert = 1e-3, 2e-3, 1e-10, 0.2
    n_cases = 0
    # the grid above, the main shape apart (u_pass_phase holds it); then f32
    # X at the m on both sides of the cluster route's crossover at each k
    # (mu_fused.cluster_max_m: the widest m whose CTA fits), rows of one,
    # 17 and, at k = 20 and 32, 30000
    cases = [(n, m, k, ("bfloat16", "float32")) for n in (1, 17, N)
             for m in (1, 15, 4097, M)
             for k in (1, 7, 20, 32, 33, 64, 100, 128, 129, 200)
             if (n, m) != (N, M)]
    cases += [(n, mu_fused.cluster_max_m(k) + d, k, ("float32",))
              for k in (1, 7, 20, 32) for d in (0, 1)
              for n in ((1, 17, N) if k in (20, 32) else (1, 17))]
    for n, m, k, xnames in cases:
        X32, U, V, Vn, Xn32 = upass_inputs(torch, rng, n, m, k, dev)
        Us = U * torch.where(torch.rand_like(U) < 0.5, -1.0, 1.0)
        VtV, BtB, Hinv = upass_mats(torch, V, Vn, l2, pert)
        nv = n - 5 if n > 5 else n  # rows past n_valid zeroed
        for xname in xnames:
            dt = getattr(torch, xname)
            X, Xn = X32.to(dt), Xn32.to(dt)
            row_sq = (Xn.float() ** 2).sum(dim=1)
            tag = f"n={n} m={m} k={k} {xname}"

            def mu():
                return mu_fused.fused_mu_u_pass(X, U, V, VtV, l1, l2,
                                                eps, n_valid=nv)
            got, again = nan_filled(mu), mu()
            torch.cuda.synchronize()
            want = mu_fused.fused_mu_u_pass_ref(X, U, V, VtV, l1, l2,
                                                eps, n_valid=nv)
            same = all(bool(torch.equal(a, b))
                       for a, b in zip(got, again))
            ok = bool(torch.allclose(got[0], want[0], rtol=1e-4,
                                     atol=1e-30))
            e1, e2 = own_products(torch, mu_fused, X, got)
            check(ok and e1 <= 1e-4 and e2 <= 1e-4 and same,
                  f"K1[{tag}, n_valid={nv}] U_new rtol 1e-4 {ok}, "
                  f"numV {e1:.3g}, gramU {e2:.3g} <= 1e-4, two "
                  f"calls bitwise equal {same}")
            for trials in (0, TRIALS):
                for nonneg in (True, False):
                    Uk = U if nonneg else Us
                    args = (Xn, Uk, Vn, BtB, Hinv, row_sq, l1, l2)
                    kw = dict(trials=trials, non_negative=nonneg)

                    def nt():
                        return newton_fused.fused_newton_linear_u_pass(
                            *args, **kw)
                    got, again = nan_filled(nt), nt()
                    torch.cuda.synchronize()
                    want = newton_fused.fused_newton_linear_u_pass_ref(
                        *args, **kw)
                    same = all(bool(torch.equal(a, b))
                               for a, b in zip(got, again))
                    agree = newton_rows_agree(got[0], want[0])
                    extra, rows_ok = "", agree >= 0.999
                    if not rows_ok:
                        # float64, keeping the contract's
                        # rounding point: V at X's dtype
                        w64 = newton_fused.fused_newton_linear_u_pass_ref(
                            Xn.double(), Uk.double(),
                            Vn.to(Xn.dtype).double(),
                            *(a.double() for a in args[3:6]), l1, l2,
                            **kw)[0]
                        a_k = newton_rows_agree(got[0], w64)
                        a_p = newton_rows_agree(want[0], w64)
                        extra = (f"; vs float64: kernel {a_k:.6f} "
                                 f">= plain f32 {a_p:.6f}")
                        rows_ok = a_k >= a_p
                    e1 = own_products(torch, mu_fused, Xn, got)[0]
                    check(rows_ok and e1 <= 1e-3 and same,
                          f"K2[{tag}, trials={trials}, non_negative="
                          f"{nonneg}] rows agreeing {agree:.6f} >= "
                          f"0.999{extra}, numV {e1:.3g} <= 1e-3, two "
                          f"calls bitwise equal {same}")
            n_cases += 5
        del X32, U, V, Vn, Xn32
    torch.cuda.empty_cache()
    log(f"  K1/K2 edges: {n_cases} cases")


def u_pass_phase(check, torch, mu_fused, newton_fused):
    """Phase 3, K1 and K2: each against its plain version at the main
    shape, bf16 and f32 X (outputs NaN-filled, two calls bitwise equal),
    at k = 20 and on the wide route at k in WIDE_UPASS_K (u_pass_wide),
    then at the edges (u_pass_edges)."""
    rec = u_pass_main(check, torch, mu_fused, newton_fused, K, SEED)
    for k in WIDE_UPASS_K:
        rec.update(u_pass_main(check, torch, mu_fused, newton_fused, k,
                               SEED + 24))
    u_pass_edges(check, torch, mu_fused, newton_fused)
    return rec


WIDE_UPASS_K = (40, 100)  # K1/K2's wide route at the main shape


def u_pass_main(check, torch, mu_fused, newton_fused, k, seed):
    """K1 and K2 at the main shape and k components, bf16 and f32 X, each
    against its plain version (K1's U_new rtol 1e-4, numV and gramU 1e-4
    relative Frobenius; K2's rows agreeing 0.999, numV 1e-3), outputs
    NaN-filled, two calls bitwise equal, timed beside the plain version.
    Keyed (<kernel>, dtype) at k <= 32 and (<kernel>_wide, dtype, k) on the
    wide route (k > 32: u_pass_wide.cu). The bound counts X once and the
    factors (bytes) against 4 n m k flops at the type's rate; on the wide
    route f32 X's operations are its split products instead, six TF32
    products for X V and three for X^T U_new, 2 n m k flops each, at the
    TF32 rate."""
    import numpy as np

    rng = np.random.RandomState(seed)
    dev = torch.device("cuda")
    wide = k > mu_fused.K_NARROW
    X32, U, V, Vn, Xn32 = upass_inputs(torch, rng, N, M, k, dev)
    l1, l2, eps, pert = 1e-3, 2e-3, 1e-10, 0.2
    VtV, BtB, Hinv = upass_mats(torch, V, Vn, l2, pert)
    rec = {}
    for xname in ("bfloat16", "float32"):
        X, Xn = X32.to(getattr(torch, xname)), Xn32.to(getattr(torch, xname))
        row_sq = (Xn.float() ** 2).sum(dim=1)
        xb = X.element_size()
        nbytes = N * M * xb + 4 * (3 * N * k + 2 * M * k + 2 * k * k)
        if xb == 2:
            bms, bby = bound(nbytes, 4.0 * N * M * k, BF16_FLOPS)
        elif wide:
            bms, bby = bound(nbytes, 9 * 2.0 * N * M * k, TF32_FLOPS)
        else:
            bms, bby = bound(nbytes, 4.0 * N * M * k, F32_FLOPS)
        log(f"phase 3: X {xname}, k={k}")
        kw = dict(trials=TRIALS, non_negative=True)
        args = (Xn, U, Vn, BtB, Hinv, row_sq, l1, l2)
        for name, short, fn, ref in (
                ("fused_mu_u_pass", "K1",
                 lambda: mu_fused.fused_mu_u_pass(X, U, V, VtV, l1, l2, eps),
                 lambda: mu_fused.fused_mu_u_pass_ref(X, U, V, VtV, l1, l2,
                                                      eps)),
                ("fused_newton_linear_u_pass", "K2",
                 lambda: newton_fused.fused_newton_linear_u_pass(*args, **kw),
                 lambda: newton_fused.fused_newton_linear_u_pass_ref(
                     *args, **kw))):
            tag = f"{short}[{xname}, k={k}]"
            out, again = nan_filled(fn), fn()
            torch.cuda.synchronize()
            want = ref()
            torch.cuda.synchronize()
            err = float((out[0] - want[0]).abs().max())
            if short == "K1":
                check(bool(torch.allclose(out[0], want[0], rtol=1e-4,
                                          atol=0.0)),
                      f"{tag} U_new rtol 1e-4 (max abs err {err:.3g})")
                for i, nm in ((1, "numV"), (2, "gramU")):
                    e = rel_fro(out[i], want[i])
                    check(e <= 1e-4, f"{tag} {nm} rel Frobenius {e:.3g} "
                          "<= 1e-4")
            else:
                agree = newton_rows_agree(out[0], want[0])
                check(agree >= 0.999, f"{tag} U_new rows agreeing to rtol "
                      f"1e-4: {agree:.6f} >= 0.999 (max abs err {err:.3g})")
                e = rel_fro(out[1], want[1])
                check(e <= 1e-3, f"{tag} numV rel Frobenius {e:.3g} <= 1e-3")
            check(all(bool(torch.equal(a, b)) for a, b in zip(out, again)),
                  f"{tag} outputs NaN-filled, two calls bitwise equal")
            ms, dms, pms = time_ms(fn), device_ms(fn), time_ms(ref)
            log(f"  {tag}{' wide route:' if wide else ''} kernel {ms:.4f} ms "
                f"(device alone {dms:.4f}), plain {pms:.4f} ms, bound "
                f"{bms:.4f} ms ({bby})")
            key = (name + "_wide", xname, k) if wide else (name, xname)
            rec[key] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                            plain_ms=pms, bound_ms=bms, bound_by=bby)
            del out, again, want
        if xname == "float32" and not wide:
            # the cluster route: the plan's clusters, the card's resident
            # ones (cudaOccupancyMaxActiveClusters), one read of X
            plan = mu_fused.plan_for(X, k)
            limit = mu_fused.cluster_limit(X.device.index, k,
                                           plan.slice_cols)
            check(0 < plan.clusters <= limit,
                  f"K1/K2[float32] take the cluster route: {plan.clusters} "
                  f"clusters of 16 CTAs, {plan.slice_cols} columns a CTA; "
                  f"the card holds {limit} at once")
            rec[("fused_mu_u_pass", xname)].update(
                clusters=plan.clusters, resident_clusters=limit,
                slice_cols=plan.slice_cols)
        del X, Xn, row_sq, args
    del X32, Xn32, U, V, Vn
    torch.cuda.empty_cache()
    return rec


def sm_clock_hz() -> float:
    """The SM clock the card reports as its maximum (nvidia-smi), for the
    SFU's rate; the data sheet's 1980 MHz if it gives none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return 1.98e9


def sigmoid_bound(n, q, k, slots, x_bytes, clock_hz, gh) -> tuple:
    """(least ms for K3 (gh) or K4 on this card, what bounds it): the
    largest of the bytes over the DRAM rate, the tensor-core products (3
    passes each: 3xTF32 over the TF32 peak, split bf16 over the bf16 peak),
    the f32 work left on the CUDA cores over the f32 peak, and the sigmoids
    (two MUFU operations each) over the SFU rate at the reported clock. K3:
    logits and G (3xTF32) and H's packed triangle (split bf16) per element
    of X, one sigmoid, ~6 f32 operations (f', W, RF); K4: logits per
    (element, slot) (3xTF32), a sigmoid and ~4 f32 operations (residual,
    square, sum, the candidate's entry)."""
    if gh:
        nbytes = n * q * x_bytes + 4.0 * (2 * n * k + q * k + n * k * k)
        tc = (2.0 * n * q * 2 * k * 3 / TF32_FLOPS
              + 2.0 * n * q * (k * (k + 1) // 2) * 3 / BF16_FLOPS)
        f32, sig = 6.0 * n * q, float(n) * q
    else:
        nbytes = n * q * x_bytes + 4.0 * (3 * n * k + q * k + n * slots)
        tc = 2.0 * n * q * k * slots * 3 / TF32_FLOPS
        f32, sig = 4.0 * n * q * slots, float(n) * q * slots
    times = {"bytes": nbytes / HBM_BPS, "tensor cores": tc,
             "f32 operations": f32 / F32_FLOPS,
             "sigmoids": 2.0 * sig / (SFU_PER_SM_CLOCK * SMS * clock_hz)}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def sig_inputs(torch, rng, n, q, k, dev):
    """0/1 labels (exact in bf16) and N(0, 0.3²) factors: O(1) logits."""
    import numpy as np

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return (f32((rng.rand(n, q) < 0.3).astype(np.float32)),
            f32(0.3 * rng.randn(n, k)), f32(0.3 * rng.randn(q, k)))


def sigmoid_edges(check, torch, sigmoid_newton, batched_solve):
    """K3, K4 at the edges: n in {1, 17, 20, 30000}, q in {1, 15, 4097,
    11314}, k in {1, 7, 20, 32, 33, 64, 100}, bf16 and f32 X, K4 with
    trials 0 and TRIALS and non_negative both ways; then the route that
    reads M, d and B from device memory (plan ops_smem = 0: the operands no
    longer fit in shared memory beside the ring), K3 at k = 256 and K4 at
    k = 128 with the most trials it takes (MAX_SLOTS - 1 = 255), at n in
    {17, 20} and q in {15, 4097}. Every
    output and the workspace NaN-filled before the call, a second call
    bitwise equal, the bars of the main shapes (sigmoid_phase). K4's d is
    the Newton direction of its factors, as in sigmoid_phase and in a fit:
    with an arbitrary d most slots tie slot 0 within rounding, and the
    slot-agreement bar assumes they do not. Where fewer than 0.999 of the
    rows select the plain version's slot, the bar applies to the rows whose
    slot float64 decides (decided_rows: every deciding phi difference above
    2^-20 of phi, at least 0.9 of the rows): there the kernel must select
    a float64 evaluation's slot on >= 0.999 of them. At k = 1 (30000 x
    4097) ~0.5% of the rows' slots tie slot 0 within phi's float32
    rounding: the plain float32 version matches float64 on only ~0.997 of
    all rows, and which of the two float32 versions matches more of them
    changes with the seed (`chip_ab --phase ties`, PERF.md §6). This
    relaxes the 0.999 bar on those tie rows. Skipped for time: (30000,
    11314), held at k = 20 by sigmoid_phase, and the shapes whose H build
    exceeds 1e11 products (n q k(k+1)/2: 30000 x 4097 at k >= 64)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 5)
    l1, l2, pert = 0.5, 1.0, 0.2
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def case(n, q, k, trials_set, gh_only=False, ops_smem=None):
        lab, Mf, Bf = sig_inputs(torch, rng, n, q, k, dev)
        eye = (l2 + pert) * torch.eye(k, device=dev)
        cases = 0
        for xname in ("bfloat16", "float32"):
            X = lab.to(getattr(torch, xname))
            xb = X.element_size()
            tag = f"n={n} q={q} k={k} {xname}"
            if ops_smem is not None:
                route = (sigmoid_newton.gh_plan(n, q, k, xb, n_sm).ops_smem
                         if gh_only else
                         sigmoid_newton.phi_plan(n, q, k, max(trials_set) + 1,
                                                 xb, n_sm).ops_smem)
                check(route == ops_smem, f"{'K3' if gh_only else 'K4'}"
                      f"[{tag}] plan ops_smem {route} == {ops_smem}")

            def gh():
                return sigmoid_newton.sigmoid_gh_pass(X, Mf, Bf, l1, l2)
            if gh_only or ops_smem is None:
                got, again = nan_filled(gh), gh()
                torch.cuda.synchronize()
                want = sigmoid_newton.sigmoid_gh_pass_ref(X, Mf, Bf, l1, l2)
                eg, eh = rel_fro(got[0], want[0]), rel_fro(got[1], want[1])
                same = all(bool(torch.equal(a, b))
                           for a, b in zip(got, again))
                check(eg <= 1e-4 and eh <= 1e-4 and same,
                      f"K3[{tag}] G rel Frobenius {eg:.3g}, H {eh:.3g} <= "
                      f"1e-4 (outputs and scratch NaN-filled), two calls "
                      f"bitwise equal {same}")
                cases += 1
            if gh_only:
                continue
            for nonneg in (True, False):
                Mk = Mf.abs() if nonneg else Mf
                Gk, Hk = sigmoid_newton.sigmoid_gh_pass_ref(X, Mk, Bf, l1, l2)
                d = torch.linalg.solve(Hk + eye, Gk[..., None])[..., 0]
                for trials in trials_set:
                    kw = dict(trials=trials, non_negative=nonneg)

                    def phi():
                        return sigmoid_newton.sigmoid_phi_pass(
                            X, Mk, d, Bf, l1, l2, **kw)
                    got, again = nan_filled(phi), phi()
                    torch.cuda.synchronize()
                    want = sigmoid_newton.sigmoid_phi_pass_ref(
                        X, Mk, d, Bf, l1, l2, **kw)
                    rel = float((got - want).abs().max() / want.abs().max())
                    agree = slot_agreement(got, want)
                    extra, rows_ok = "", agree >= 0.999
                    if not rows_ok:
                        w64 = sigmoid_newton.sigmoid_phi_pass_ref(
                            X.double(), Mk.double(), d.double(),
                            Bf.double(), l1, l2, **kw)
                        rows = decided_rows(w64, TIE_REL)
                        dec = float(rows.float().mean())
                        a_k = slot_agreement(got, w64, rows)
                        a_p = slot_agreement(want, w64, rows)
                        extra = (f"; on the {dec:.6f} >= {MIN_DECIDED} of "
                                 f"rows float64 decides by > 2^-20 of phi: "
                                 f"kernel vs float64 {a_k:.6f} >= 0.999 "
                                 f"(plain f32 {a_p:.6f})")
                        rows_ok = dec >= MIN_DECIDED and a_k >= 0.999
                    same = bool(torch.equal(got, again))
                    check(rel <= 2e-5 and rows_ok and same,
                          f"K4[{tag}, trials={trials}, non_negative="
                          f"{nonneg}] max abs phi err {rel:.3g} of the "
                          f"largest |phi| <= 2e-5, rows selecting the same "
                          f"slot {agree:.6f} >= 0.999{extra}, two calls "
                          f"bitwise equal {same}")
                    cases += 1
        return cases

    n_cases = skipped = 0
    for n in (1, 17, 20, N):
        for q in (1, 15, 4097, M):
            for k in (1, 7, 20, 32, 33, 64, 100):
                if (n, q) == (N, M) or n * q * k * (k + 1) / 2 > 1e11:
                    skipped += 1
                    continue
                n_cases += case(n, q, k, (0, TRIALS))
    for n, q in ((17, 15), (20, 4097)):
        n_cases += case(n, q, 256, (), gh_only=True, ops_smem=0)
        n_cases += case(n, q, 128, (sigmoid_newton.MAX_SLOTS - 1,),
                        ops_smem=0)
    torch.cuda.empty_cache()
    log(f"  K3/K4 edges: {n_cases} cases, {skipped} shapes skipped")


def sigmoid_phase(check, torch, sigmoid_newton, batched_solve):
    """Phase 3, K3, K4, K5: each against its plain version.

    Inputs: 0/1 labels (exact in bf16) and N(0, 0.3²) factors, so logits
    are O(1) as in a fit; penalties large enough to show in phi (about
    3 of phi's ~1.5e3 per row), so a phi without them fails. Shapes: path
    A's Z update (Yᵀ 20 x 11314, bf16), path B's U and V updates (X 30000 x
    11314, bf16 and f32, and Xᵀ 11314 x 30000, bf16). Tolerances:
    G and H by relative Frobenius norm, 1e-4 (f32 sums over q terms in two
    orders); phi by its largest deviation, 2e-5 of the table's largest |phi|
    (f32 sums of q = 11314 terms in two orders, about 3·sqrt(q)·2⁻²⁴), and
    by the share of rows whose selected line-search slot agrees, >= 0.999
    (a slot whose phi ties slot 0 within rounding may flip); d by relative
    Frobenius norm, 1e-3 (the same f32 systems, cond(H) amplifies the
    different rounding). The edges are sigmoid_edges."""
    import numpy as np

    rng = np.random.RandomState(SEED + 1)
    dev = torch.device("cuda")
    l1, l2, pert = 0.5, 1.0, 0.2
    clock = sm_clock_hz()
    log(f"phase 3: SFU rate at {clock / 1e6:.0f} MHz")
    rec = {}
    H_b = G_b = None
    for shape, n, q, xnames in (("A", K, M, ("bfloat16",)),
                                ("B", N, M, ("bfloat16", "float32")),
                                ("Bt", M, N, ("bfloat16",))):
        lab, Mf, Bf = sig_inputs(torch, rng, n, q, K, dev)
        for xname in xnames:
            X = lab.to(torch.bfloat16) if xname == "bfloat16" else lab
            tag = f"{shape}[{xname}]"
            xb = X.element_size()
            # K3
            G, H = nan_filled(lambda: sigmoid_newton.sigmoid_gh_pass(
                X, Mf, Bf, l1, l2))
            G2, H2 = sigmoid_newton.sigmoid_gh_pass(X, Mf, Bf, l1, l2)
            torch.cuda.synchronize()
            Gr, Hr = sigmoid_newton.sigmoid_gh_pass_ref(X, Mf, Bf, l1, l2)
            torch.cuda.synchronize()
            eg, eh = rel_fro(G, Gr), rel_fro(H, Hr)
            check(eg <= 1e-4 and eh <= 1e-4, f"K3{tag} G rel Frobenius "
                  f"{eg:.3g}, H {eh:.3g} <= 1e-4")
            check(torch.equal(G, G2) and torch.equal(H, H2),
                  f"K3{tag} outputs NaN-filled, two calls bitwise equal")
            err3 = max(float((G - Gr).abs().max()), float((H - Hr).abs().max()))
            Hs = Hr + (l2 + pert) * torch.eye(K, device=dev)
            d = batched_solve.batched_spd_solve_ref(Hs, Gr)
            if shape == "B" and xname == "bfloat16":
                H_b, G_b = Hr, Gr
            # K4
            kw = dict(trials=TRIALS, non_negative=True)
            phi = nan_filled(lambda: sigmoid_newton.sigmoid_phi_pass(
                X, Mf, d, Bf, l1, l2, **kw))
            phi2 = sigmoid_newton.sigmoid_phi_pass(X, Mf, d, Bf, l1, l2, **kw)
            torch.cuda.synchronize()
            phr = sigmoid_newton.sigmoid_phi_pass_ref(X, Mf, d, Bf, l1, l2,
                                                      **kw)
            torch.cuda.synchronize()
            agree = float((selected_slot(phi) == selected_slot(phr))
                          .float().mean())
            err4 = float((phi - phr).abs().max())
            rel4 = err4 / float(phr.abs().max())
            check(rel4 <= 2e-5, f"K4{tag} max abs phi err {err4:.3g}, "
                  f"{rel4:.3g} of the largest |phi| <= 2e-5")
            check(agree >= 0.999, f"K4{tag} rows selecting the same slot "
                  f"{agree:.6f} >= 0.999")
            check(torch.equal(phi, phi2),
                  f"K4{tag} output NaN-filled, two calls bitwise equal")
            b3 = sigmoid_bound(n, q, K, 1, xb, clock, True)
            b4 = sigmoid_bound(n, q, K, TRIALS + 1, xb, clock, False)

            def k3():
                return sigmoid_newton.sigmoid_gh_pass(X, Mf, Bf, l1, l2)

            def k4():
                return sigmoid_newton.sigmoid_phi_pass(X, Mf, d, Bf, l1, l2,
                                                       **kw)
            t3, dt3 = time_ms(k3), device_ms(k3)
            p3 = time_ms(lambda: sigmoid_newton.sigmoid_gh_pass_ref(
                X, Mf, Bf, l1, l2), reps=5)
            t4, dt4 = time_ms(k4), device_ms(k4)
            p4 = time_ms(lambda: sigmoid_newton.sigmoid_phi_pass_ref(
                X, Mf, d, Bf, l1, l2, **kw), reps=5)
            log(f"  K3{tag} kernel {t3:.4f} ms (device alone {dt3:.4f}), "
                f"plain {p3:.4f} ms, bound {b3[0]:.4f} ms ({b3[1]}); "
                f"K4{tag} kernel {t4:.4f} ms (device alone {dt4:.4f}), "
                f"plain {p4:.4f} ms, bound {b4[0]:.4f} ms ({b4[1]})")
            rec[("sigmoid_gh_pass", tag)] = dict(
                max_abs_err=err3, ms=t3, device_ms=dt3, plain_ms=p3,
                bound_ms=b3[0], bound_by=b3[1])
            rec[("sigmoid_phi_pass", tag)] = dict(
                max_abs_err=err4, ms=t4, device_ms=dt4, plain_ms=p4,
                bound_ms=b4[0], bound_by=b4[1], slot_agreement=agree)
            del G, H, G2, H2, Gr, Hr, phi, phi2, phr, d
        del lab, X, Mf, Bf
    # K5 on the real Gauss-Newton systems of the sigmoid-X shape, given
    # whole (H) and as the Newton solver passes them (the per-row part and
    # H_shared, which the kernel adds as it reads each system)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    shared = (l2 + pert) * torch.eye(K, device=dev)
    for p in (M, N):
        Hr, G = H_b[:p].contiguous(), G_b[:p].contiguous()
        H = Hr + shared
        d = batched_solve.batched_spd_solve(H, G)
        d_sh = batched_solve.batched_spd_solve(Hr, G, shared)
        torch.cuda.synchronize()
        dr = batched_solve.batched_spd_solve_ref(H, G)
        e = rel_fro(d, dr)
        res = float((torch.linalg.matmul(H.double(), d.double()[..., None])[..., 0]
                     - G.double()).norm() / G.double().norm())
        check(e <= 1e-3, f"K5[p={p}] d rel Frobenius {e:.3g} <= 1e-3; "
              f"kernel residual |Hd - G|/|G| {res:.3g}")
        check(bits_equal(torch, d, d_sh), f"K5[p={p}] with H_shared equals "
              f"the solve of H + H_shared bit for bit")
        b5 = bound(spd_bytes(p, K), p * (K ** 3 / 3.0 + 2 * K * K),
                   F32_FLOPS)
        flush = flush_buf.zero_

        def k5():
            return batched_solve.batched_spd_solve(H, G)

        def k5_shared():
            return batched_solve.batched_spd_solve(Hr, G, shared)

        def library():
            return torch.linalg.solve(H, G[..., None])
        t5 = time_ms(k5, reps=20, flush=flush)
        dt5 = device_ms(k5, reps=20, flush=flush)
        ts5 = time_ms(k5_shared, reps=20, flush=flush)
        dts5 = device_ms(k5_shared, reps=20, flush=flush)
        p5 = time_ms(lambda: batched_solve.batched_spd_solve_ref(H, G),
                     reps=20, flush=flush)
        lib = time_ms(library, reps=20, flush=flush)
        dlib = device_ms(library, reps=20, flush=flush)
        log(f"  K5[p={p}] kernel {t5:.4f} ms (device alone {dt5:.4f}; with "
            f"H_shared {ts5:.4f}, device {dts5:.4f}), plain {p5:.4f} ms, "
            f"torch.linalg.solve {lib:.4f} ms (device {dlib:.4f}), bound "
            f"{b5[0]:.4f} ms ({b5[1]}); L2 flushed before each call")
        rec[("batched_spd_solve", p)] = dict(
            max_abs_err=float((d - dr).abs().max()), ms=t5, device_ms=dt5,
            shared_ms=ts5, shared_device_ms=dts5, plain_ms=p5,
            library_ms=lib, library_device_ms=dlib, bound_ms=b5[0],
            bound_by=b5[1])
    del flush_buf, H_b, G_b
    torch.cuda.empty_cache()
    return rec


WIDE_K = (33, 40, 48, 64)   # K5's wide route: phase 3's shapes
WIDE_P = (20, M, N)  # Z's systems (P_LATENCY), V's, U's


def k5_wide_phase(check, torch, batched_solve):
    """Phase 3, K5's wide route (32 < k <= 64: a warp per system, its rows
    in registers) at k in WIDE_K on p in WIDE_P systems, against its plain
    version (rel. Frobenius <= 1e-3, the bar of the k = 20 systems),
    whole and with H_shared apart (bit for bit equal to the whole), each
    timed beside its bound, torch.linalg.solve and the blocked route
    (``batched_spd_solve_block``, the k > 64 route) on the same systems.
    The systems are Gauss-Newton Hessians of a sigmoid term, H = Bᵀ
    diag(σ′²) B over 2048 columns (N(0, 0.3²) factors) plus 1.2 I, the
    solver's damping; G ~ N(0, 1). L2 flushed before each timed call."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 7)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    rec = {}
    for k in WIDE_K:
        B = torch.from_numpy(0.3 * rng.randn(2048, k).astype(np.float32)) \
            .to(dev)
        BB = (B[:, :, None] * B[:, None, :]).reshape(2048, k * k)
        shared = 1.2 * torch.eye(k, device=dev)
        for p in WIDE_P:
            Mf = torch.from_numpy(0.3 * rng.randn(p, k).astype(np.float32)) \
                .to(dev)
            P = torch.sigmoid(Mf @ B.T)
            Hr = (((P * (1 - P)) ** 2) @ BB).reshape(p, k, k)
            G = torch.from_numpy(rng.randn(p, k).astype(np.float32)).to(dev)
            H = Hr + shared
            del Mf, P
            d = nan_filled(lambda: batched_solve.batched_spd_solve(H, G))
            d_sh = batched_solve.batched_spd_solve(Hr, G, shared)
            again = batched_solve.batched_spd_solve(H, G)
            torch.cuda.synchronize()
            dr = batched_solve.batched_spd_solve_ref(H, G)
            e = rel_fro(d, dr)
            check(e <= 1e-3 and bits_equal(torch, d, again),
                  f"K5 wide[p={p} k={k}] d rel Frobenius {e:.3g} <= 1e-3 "
                  f"(output NaN-filled), two calls bitwise equal")
            check(bits_equal(torch, d, d_sh), f"K5 wide[p={p} k={k}] with "
                  f"H_shared equals the solve of H + H_shared bit for bit")
            b5 = bound(spd_bytes(p, k), p * (k ** 3 / 3.0 + 2 * k * k),
                       F32_FLOPS)

            def k5():
                return batched_solve.batched_spd_solve(H, G)

            def k5_shared():
                return batched_solve.batched_spd_solve(Hr, G, shared)

            def blocked():
                return batched_solve.batched_spd_solve_block(Hr, G, shared)

            def library():
                return torch.linalg.solve(H, G[..., None])
            reps = 20 if p > P_LATENCY else 50
            t5 = time_ms(k5, reps=reps, flush=flush)
            dt5 = device_ms(k5, reps=reps, flush=flush)
            ts5 = time_ms(k5_shared, reps=reps, flush=flush)
            dts5 = device_ms(k5_shared, reps=reps, flush=flush)
            dtb = device_ms(blocked, reps=reps, flush=flush)
            p5 = time_ms(lambda: batched_solve.batched_spd_solve_ref(H, G),
                         reps=10, flush=flush)
            lib = time_ms(library, reps=10, flush=flush)
            dlib = device_ms(library, reps=10, flush=flush)
            log(f"  K5 wide[p={p} k={k}] kernel {t5:.4f} ms (device alone "
                f"{dt5:.4f}; with H_shared {ts5:.4f}, device {dts5:.4f}), "
                f"blocked route device {dtb:.4f}, plain {p5:.4f} ms, "
                f"torch.linalg.solve {lib:.4f} ms (device {dlib:.4f}), "
                f"bound {b5[0]:.4f} ms ({b5[1]})")
            rec[("batched_spd_solve_wide", p, k)] = dict(
                max_abs_err=float((d - dr).abs().max()), ms=t5,
                device_ms=dt5, shared_ms=ts5, shared_device_ms=dts5,
                blocked_device_ms=dtb, plain_ms=p5, library_ms=lib,
                library_device_ms=dlib, bound_ms=b5[0], bound_by=b5[1])
            del H, Hr, G, d, d_sh, again, dr
        torch.cuda.empty_cache()
    del flush_buf
    torch.cuda.empty_cache()
    return rec


BLOCK_K = (65, 100, 128)  # K5's block route (k > 64) at 11314 systems
LU_K = (20, 40, 100)      # its LU route (the full Hessian form)
P_LATENCY = 20            # Z's systems on paths A and H: one SM per system
P_TOP = 512               # systems past block_max_k: the scratch slots
P_WIDE = 33               # systems at the largest k (work area in the slot)


def gn_systems(torch, rng, p, k):
    """(H_rows, H_shared, G): Gauss-Newton Hessians of a sigmoid term,
    H_rows = Bᵀ diag(σ′²) B over 2048 columns (N(0, 0.3²) factors), the
    solver's damping 1.2 I, G ~ N(0, 1) (k5_wide_phase's systems)."""
    import numpy as np

    dev = torch.device("cuda")
    B = torch.from_numpy(0.3 * rng.randn(2048, k).astype(np.float32)).to(dev)
    Mf = torch.from_numpy(0.3 * rng.randn(p, k).astype(np.float32)).to(dev)
    P = torch.sigmoid(Mf @ B.T)
    Hr = torch.empty((p, k * k), device=dev)
    rows = max(1, (1 << 28) // (4 * k * k))  # (rows, k²) blocks of ~256 MB
    for i in range(0, p, rows):
        Hr[i:i + rows] = ((P[i:i + rows] * (1 - P[i:i + rows])) ** 2) \
            @ (B[:, :, None] * B[:, None, :]).reshape(2048, k * k)
    G = torch.from_numpy(rng.randn(p, k).astype(np.float32)).to(dev)
    return Hr.view(p, k, k), 1.2 * torch.eye(k, device=dev), G


def indefinite_systems(torch, rng, p, k):
    """(H_rows, H_shared, G): Q diag(λ) Qᵀ - 0.2 I with |λ| in [1, 3] and
    each sign flipped at random (λ₀ < 0), plus H_shared = 0.2 I: symmetric,
    indefinite, cond <= 3."""
    import numpy as np

    dev = torch.device("cuda")
    Q = torch.linalg.qr(torch.from_numpy(
        rng.randn(p, k, k).astype(np.float32)).to(dev))[0]
    lam = (1.0 + 2.0 * rng.rand(p, k)) * np.where(rng.rand(p, k) < 0.5,
                                                   -1.0, 1.0)
    lam[:, 0] = -np.abs(lam[:, 0])
    lam = torch.from_numpy(lam.astype(np.float32)).to(dev)
    eye = torch.eye(k, device=dev)
    H = (Q * lam[:, None, :]) @ Q.mT - 0.2 * eye
    G = torch.from_numpy(rng.randn(p, k).astype(np.float32)).to(dev)
    return H.contiguous(), 0.2 * eye, G


def k5_block_shapes(batched_solve) -> dict:
    """The block and LU routes' crossovers on this card (the launch plan's):
    the largest k one CTA holds, and the least k whose scratch slot takes
    the work area too (shared memory no longer holds it)."""
    import torch

    optin = batched_solve.smem_optin(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    top = {}
    for lu, sfx in ((False, ""), (True, "_lu")):
        top["block_max_k" + sfx] = kb = batched_solve.block_max_k(0, lu)
        top["slot_all_k" + sfx] = next(
            k for k in range(kb + 1, 1 << 14)
            if batched_solve.solve_plan(1, k, lu, optin, sms).place
            == batched_solve.SLOT_ALL)
    return top


def k5_block_cases(top) -> list:
    """(name, p, k, kind) of phase 3's block and LU shapes."""
    spd, lu = "batched_spd_solve_block", "batched_lu_solve"
    cases = [(spd, M, k, "spd") for k in BLOCK_K]
    cases += [(spd, P_LATENCY, 100, "spd")]
    cases += [(spd, 2048, k, "spd") for k in sorted(
        {top["block_max_k"], top["block_max_k"] + 1, 239, 240})]
    cases += [(spd, P_TOP, 444, "spd"),
              (spd, P_WIDE, top["slot_all_k"], "wide spd")]
    cases += [(lu, M, k, kind) for k in LU_K
              for kind in ("spd", "indefinite")]
    cases += [(lu, P_LATENCY, 20, "spd"),
              (lu, 2048, top["block_max_k_lu"] + 1, "indefinite"),
              (lu, P_TOP, 385, "indefinite"),
              (lu, P_WIDE, top["slot_all_k_lu"], "wide indefinite")]
    return cases


def wide_systems(torch, p, k, kind, seed):
    """(H_rows, H_shared, G) at a k whose Gauss-Newton Hessians would take
    a (2048, k²) product: 'wide spd' A Aᵀ + 0.8 I + H_shared 0.2 I with A
    N(0, 1/k) (k × k: eigenvalues in [1, 5]); 'wide indefinite' the rows of
    3 I + A (singular values in about [1, 5]) in a random order, so that
    every column pivots, H_shared 0; drawn on the card from ``seed``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    eye = torch.eye(k, device=dev)
    A = torch.randn((p, k, k), device=dev, generator=gen) / k ** 0.5
    if kind == "wide spd":
        H, Hs = A @ A.mT + 0.8 * eye, 0.2 * eye
    else:
        order = torch.argsort(torch.rand((p, k), device=dev, generator=gen))
        H = torch.gather(A + 3.0 * eye, 1, order[:, :, None].expand(p, k, k))
        Hs = torch.zeros_like(eye)
    G = torch.randn((p, k), device=dev, generator=gen)
    return H.contiguous(), Hs, G


def k5_block_lu_phase(check, torch, batched_solve):
    """Phase 3, K5's block route (SPD, k > 64) and LU route (partial
    pivoting: the full Hessian form), each in every regime of the launch
    plan: the LU route's warp per system (k <= 32), one CTA per system in
    shared memory (to block_max_k), past it global scratch slots (two an
    SM), the work area in shared memory while it fits, else in the slot
    (from slot_all_k). Shapes: the block route at k in BLOCK_K on 11314
    systems, at P_LATENCY x 100 (Z's systems on path A at k = 100), at
    block_max_k, one above, 239 and 240 on 2048, at 444 on P_TOP and at
    slot_all_k on P_WIDE; the LU route at k in LU_K on 11314 Gauss-Newton
    (SPD) and indefinite systems, at P_LATENCY x 20 (path H's Z), at
    block_max_k (LU's) + 1 on 2048, at 385 on P_TOP and at its slot_all_k
    on P_WIDE (wide_systems there). Each against its plain version
    (relative Frobenius <= 1e-3, K5's bar), output NaN-filled, two calls
    bitwise equal, H_shared apart bit for bit equal to the solve of the
    sum; the LU route also by its residual ||(H + H_s) d - G|| / ||G|| <=
    1e-4 (float64, the systems' cond <~ 10). The P_LATENCY shapes also
    equal, bit for bit, the same systems solved among 200, and at k = 100
    the kernel's two scratch variants equal the plan's one CTA per system.
    Edges at p = 33 in every regime, slot_all_k - 1 and slot_all_k
    included: one system made singular
    (block: its sum -I; LU: all zeros) gives an all-NaN row and leaves
    every other row as the other 32 solved alone, bit for bit. Each timed
    beside its bound and torch.linalg.solve, L2 flushed."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 8)
    top = k5_block_shapes(batched_solve)
    log(f"phase 3: K5 block/LU routes, crossovers {top} (the largest k "
        f"kept in one CTA's shared memory, the least whose work area "
        f"leaves it)")
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    rec = dict(top)
    optin = batched_solve.smem_optin(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, p, k, kind in k5_block_cases(top):
        lu = name == "batched_lu_solve"
        solve = batched_solve.batched_lu_solve if lu \
            else batched_solve.batched_spd_solve
        ref = batched_solve.batched_lu_solve_ref if lu \
            else batched_solve.batched_spd_solve_ref
        if kind.startswith("wide"):
            Hr, Hs, G = wide_systems(torch, p, k, kind, SEED + k)
        else:
            Hr, Hs, G = (indefinite_systems if kind == "indefinite"
                         else gn_systems)(torch, rng, p, k)
        H = Hr + Hs
        plan = batched_solve.solve_plan(p, k, lu, optin, sms)
        tag = f"{name}[p={p} k={k} {kind}; {plan.route} place={plan.place}]"
        d = nan_filled(lambda: solve(H, G))
        again = solve(H, G)
        d_sh = solve(Hr, G, Hs)
        torch.cuda.synchronize()
        dr = ref(H, G)
        e = rel_fro(d, dr)
        check(e <= 1e-3 and bits_equal(torch, d, again)
              and bool(torch.isfinite(d).all()),
              f"{tag} d rel Frobenius {e:.3g} <= 1e-3 (output NaN-filled), "
              f"finite, two calls bitwise equal")
        check(bits_equal(torch, d, d_sh),
              f"{tag} with H_shared equals the solve of H + H_shared bit for "
              f"bit")
        if p == P_LATENCY:
            many = solve(H.repeat(10, 1, 1), G.repeat(10, 1))
            route = batched_solve.solve_plan(10 * p, k, lu, optin, sms).route
            check(bits_equal(torch, d, many[:p]),
                  f"{tag} equals the same systems solved among {10 * p} "
                  f"({route}) bit for bit")
            del many
        res = None
        if lu:
            r = (H.double() @ d.double()[..., None])[..., 0] - G.double()
            res = float(r.norm() / G.double().norm())
            check(res <= 1e-4, f"{tag} residual ||Hd - G|| / ||G|| "
                  f"{res:.3g} <= 1e-4")
        flops = k ** 3 * (2.0 if lu else 1.0) / 3.0 + 2.0 * k * k
        nbytes = 4.0 * p * (k * k + 2 * k) if lu else spd_bytes(p, k)
        b5 = bound(nbytes, p * flops, F32_FLOPS)

        def kern():
            return solve(Hr, G, Hs)

        def library():
            return torch.linalg.solve(H, G[..., None])
        reps = 10 if k <= 128 else 3 if k <= 1024 else 1
        t5 = time_ms(kern, reps=reps, flush=flush)
        dt5 = device_ms(kern, reps=reps, flush=flush)
        p5 = time_ms(lambda: ref(Hr, G, Hs), reps=min(reps, 3), flush=flush)
        lib = time_ms(library, reps=min(reps, 3), flush=flush)
        dlib = device_ms(library, reps=min(reps, 3), flush=flush)
        log(f"  {tag} kernel {t5:.4f} ms (device {dt5:.4f}), plain "
            f"{p5:.4f} ms, torch.linalg.solve {lib:.4f} ms (device "
            f"{dlib:.4f}), bound {b5[0]:.4f} ms ({b5[1]})")
        rec[(name, p, k) if not lu else (name, p, k, kind)] = dict(
            max_abs_err=float((d - dr).abs().max()), ms=t5, device_ms=dt5,
            plain_ms=p5, library_ms=lib, library_device_ms=dlib,
            bound_ms=b5[0], bound_by=b5[1], residual=res, route=plan.route,
            place=plan.place)
        del Hr, Hs, G, H, d, again, d_sh, dr
        torch.cuda.empty_cache()
    # every variant of the blocked kernel gives the plan's bits: at k = 100
    # (one CTA per system by the plan) the C entry given scratch slots, the
    # work area in shared memory and in the slot (not counted: no wrapper
    # call)
    from pycmf_tpu_torch.ops.kernels import _build
    entry = _build.function("batched_solve", "pycmf_batched_block_solve",
                            batched_solve._BLOCK_ARGTYPES)
    for lu in (False, True):
        k, p = 100, 64
        Hr, Hs, G = (indefinite_systems if lu else gn_systems)(torch, rng, p,
                                                               k)
        solve = batched_solve.batched_lu_solve if lu \
            else batched_solve.batched_spd_solve
        want = solve(Hr, G, Hs)
        for place in (batched_solve.SLOT_ROWS, batched_solve.SLOT_ALL):
            slots = p // 2  # each CTA walks two systems
            scratch = torch.empty(
                slots * batched_solve.block_slot_floats(k, lu, place),
                device=dev)
            out = torch.full_like(G, float("nan"))
            rc = entry(Hr.data_ptr(), Hs.data_ptr(), G.data_ptr(), p, k,
                       int(lu), out.data_ptr(), scratch.data_ptr(), slots,
                       batched_solve.block_threads(k, lu),
                       4 * batched_solve.block_smem_floats(k, lu, place), 0,
                       torch._C._cuda_getCurrentRawStream(0))
            torch.cuda.synchronize()
            name = "batched_lu_solve" if lu else "batched_spd_solve_block"
            check(rc == 0 and bits_equal(torch, out, want),
                  f"{name}[p={p} k={k}] in {slots} scratch slots, place "
                  f"{place} (rc {rc}), equals the plan's one CTA per system "
                  f"bit for bit")
        del Hr, Hs, G, want, out, scratch
    # edges: one singular system among 33, in every regime of the plan
    for name, k in (("batched_spd_solve_block", 65),
                    ("batched_spd_solve_block", 100),
                    ("batched_spd_solve_block", top["block_max_k"] + 1),
                    ("batched_spd_solve_block", top["slot_all_k"] - 1),
                    ("batched_spd_solve_block", top["slot_all_k"]),
                    ("batched_lu_solve", 7), ("batched_lu_solve", 20),
                    ("batched_lu_solve", 100),
                    ("batched_lu_solve", top["block_max_k_lu"] + 1),
                    ("batched_lu_solve", top["slot_all_k_lu"] - 1),
                    ("batched_lu_solve", top["slot_all_k_lu"])):
        lu = name == "batched_lu_solve"
        solve = batched_solve.batched_lu_solve if lu \
            else batched_solve.batched_spd_solve
        if k > 1024:
            Hr, Hs, G = wide_systems(
                torch, 33, k, "wide indefinite" if lu else "wide spd", k)
        else:
            Hr, Hs, G = gn_systems(torch, rng, 33, k)
        H = (Hr + Hs).contiguous()
        H[16] = 0.0 if lu else -torch.eye(k, device=dev)
        d = nan_filled(lambda: solve(H, G))
        ok = [r for r in range(33) if r != 16]
        alone = solve(H[ok].contiguous(), G[ok].contiguous())
        torch.cuda.synchronize()
        check(bool(torch.isnan(d[16]).all()) and bits_equal(torch, d[ok],
                                                             alone),
              f"{name}[edge p=33 k={k}] singular system's row all NaN, the "
              f"others as solved without it, bit for bit")
    del flush_buf
    torch.cuda.empty_cache()
    return rec


def bits_equal(torch, a, b) -> bool:
    """a and b hold the same bits (NaN included)."""
    return a.shape == b.shape and bool(torch.equal(a.view(torch.int32),
                                                   b.view(torch.int32)))


def solve_update_edges(check, torch, batched_solve, mu_update):
    """K5 and K6 at the edges of their tiles, warps and staging copies.

    K6 (fused_mu_update): p in {1, 7, R + 1, 2 SMs R + 1} for R the most
    rows a tile holds at that k (the route for k <= 32 walks whole tiles,
    and at the last p the persistent grid's tiles end ragged), k in {1, 3,
    20, 33, 64, 100} (k > 32: one thread per element), and a case whose
    M and num start 4 bytes off a 16-byte boundary (the 4-byte staging
    copies); against the plain version in float64, relative
    Frobenius <= 1e-5 (sparse_phase's bar).
    K5 (batched_spd_solve): p in {1, 20, 33}, k in {1, 3, 20, 32} and, on
    the wide route (a warp per system in registers), {33, 47, 64}, with and
    without H_shared, one case with H 4 bytes off a 16-byte boundary;
    systems A Aᵀ/k + H_shared with H_shared = 0.5 I + a random SPD part
    (or the whole sum in H), d against the float64 solve of the same f32
    systems by relative Frobenius <= 1e-4 (cond(H) below ~100 times f32
    rounding); with H_shared the result must equal the solve of the sum
    taken beforehand bit for bit (the kernel adds it in f32 as it reads);
    one system in the middle is made indefinite (its sum is -I): its row
    must be all NaN and every other row finite and unchanged, bit for bit.
    Every output NaN-filled before the call, a second call bitwise equal."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 6)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    def offset(t):
        """t's values in a tensor whose storage starts 4 bytes later."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.reshape(-1)
        return flat[1:].view(t.shape)

    n6 = 0
    for k in (1, 3, 20, 33, 64, 100):
        most = mu_update.tile_rows(1 << 30, k, n_sm) or 128
        for p in (1, 7, most + 1, 2 * n_sm * most + 1):
            M, num = f32(rng.rand(p, k)), f32(rng.rand(p, k))
            S = f32(rng.rand(k, k))
            want = mu_update.fused_mu_update_ref(M.double(), S.double(),
                                                 num.double(), 0.1, 0.2,
                                                 1e-10)
            for tag, Mi, Ni in (("", M, num),
                                (" unaligned", offset(M), offset(num))):
                if tag and p != 7:
                    continue
                got = nan_filled(lambda: mu_update.fused_mu_update(
                    Mi, S, Ni, 0.1, 0.2, 1e-10))
                again = mu_update.fused_mu_update(Mi, S, Ni, 0.1, 0.2, 1e-10)
                torch.cuda.synchronize()
                e = rel_fro(got, want)
                check(e <= 1e-5 and bits_equal(torch, got, again),
                      f"fused_mu_update[edge p={p} k={k}{tag}] rel Frobenius "
                      f"{e:.3g} <= 1e-5 (output NaN-filled), two calls "
                      f"bitwise equal")
                n6 += 1
    n5 = 0
    for k in (1, 3, 20, 32, 33, 47, 64):
        for p in (1, 20, 33):
            A = rng.randn(p, k, k)
            R = rng.randn(k, k)
            Hs = 0.5 * np.eye(k) + R @ R.T / k
            H = np.einsum("pij,pkj->pik", A, A) / k
            bad = p // 2 if p > 1 else None
            if bad is not None:
                H[bad] = -np.eye(k) - Hs
            Hr, Hsh, G = f32(H), f32(Hs), f32(rng.randn(p, k))
            Hsum = Hr + Hsh
            want = batched_solve.batched_spd_solve_ref(Hsum.double(),
                                                       G.double())
            for tag, args in (("", (Hsum, G)),
                              (" H_shared", (Hr, G, Hsh)),
                              (" unaligned", (offset(Hsum), G))):
                if tag == " unaligned" and p != 20:
                    continue
                got = nan_filled(lambda: batched_solve.batched_spd_solve(
                    *args))
                again = batched_solve.batched_spd_solve(*args)
                torch.cuda.synchronize()
                ok = [r for r in range(p) if r != bad]
                e = rel_fro(got[ok], want[ok])
                nan_row = (bad is None
                           or bool(torch.isnan(got[bad]).all()))
                finite = bool(torch.isfinite(got[ok]).all())
                check(e <= 1e-4 and nan_row and finite
                      and bits_equal(torch, got, again),
                      f"batched_spd_solve[edge p={p} k={k}{tag}] d rel "
                      f"Frobenius {e:.3g} <= 1e-4 on the SPD rows (output "
                      f"NaN-filled), indefinite row all NaN {nan_row}, "
                      f"others finite {finite}, two calls bitwise equal")
                if tag == " H_shared":
                    plain_sum = batched_solve.batched_spd_solve(Hsum, G)
                    check(bits_equal(torch, got, plain_sum),
                          f"batched_spd_solve[edge p={p} k={k}] with H_shared"
                          f" equals the solve of H + H_shared bit for bit")
                n5 += 1
    # the wide route's pivots below FLT_MIN: a subnormal first pivot gives
    # NaN in its own row (its ftz reciprocal would give inf) and no other
    for k in (33, 64):
        H = torch.eye(k, device="cuda").repeat(3, 1, 1)
        H[1, 0, 0] = 1e-40
        G = f32(rng.randn(3, k))
        got = batched_solve.batched_spd_solve(H, G)
        e = rel_fro(got[0::2], G[0::2])
        check(bool(torch.isnan(got[1]).all()) and e <= 1e-6,
              f"batched_spd_solve[edge k={k} subnormal pivot] its row all "
              f"NaN, the identity rows within {e:.3g} <= 1e-6 of g")
        n5 += 1
    torch.cuda.empty_cache()
    log(f"  K5/K6 edges: {n5} K5 cases, {n6} K6 cases")


# crafted loss sequences for the stop rule: (L0, losses, tol)
STOP_SEQUENCES = {
    "falling": (10.0, [8.0, 6.5, 6.4, 6.39], 0.01),
    "nan": (10.0, [8.0, math.nan, 5.0], 0.0),
    "plus_inf": (10.0, [8.0, math.inf, 5.0], 0.0),
    "minus_inf": (10.0, [8.0, -math.inf, 5.0], 0.0),
    "nan_L0": (math.nan, [8.0, 7.0, 6.0], 0.5),
    "L0_zero": (0.0, [0.0, 0.0, 0.0], 0.5),
    "L0_negative": (-1.0, [-2.0, -2.0, -2.0], 0.5),
    "equal_losses": (10.0, [8.0, 8.0, 7.0], 0.0),
    "tie_at_tol": (1.0, [0.75, 0.5], 0.25),
    "inexact_tie": (3.0, [1.0, 0.1, 0.09], 0.3),
    "rising": (10.0, [8.0, 9.0], -0.05),
}


def host_rule_stop(L0, losses, tol):
    """The block at which the host loop's rule stops a loss sequence (a
    non-finite loss stops it: the fit raises), or None."""
    prev = L0
    for j, loss in enumerate(losses):
        if not math.isfinite(loss) or (L0 > 0 and (prev - loss) / L0 < tol):
            return j
        prev = loss
    return None


def fit_loop_phase(check, torch):
    """stop_rule_kernel (csrc/fit_loop.cu) against stop_rule_ref on the
    card: each crafted sequence drives the kernel (eagerly, mode BLOCK per
    loss, REMAINDER after a run that did not stop) and the plain version
    on buffers of their own, loss by loss until the plain version stops;
    ctl, fctl and the history must hold the same bits, and the stop block
    must be the host loop's. Then its times: one eager call (CUDA events,
    the host's wrapper included; device alone), the plain version's, and
    inside a fit graph whose eval block is one small kernel, the device µs
    per block of 2000 blocks (the while node, the child graph and the
    rule)."""
    from pycmf_tpu_torch.ops.kernels import fit_loop as kfit

    dev = torch.device("cuda")
    f64 = torch.float64

    def control(L0, n_full, tol):
        ctl = torch.zeros(kfit.CTL_SLOTS, dtype=torch.int64, device=dev)
        fctl = torch.zeros(kfit.FCTL_SLOTS, dtype=f64, device=dev)
        hist = torch.full((n_full + 2,), math.nan, dtype=f64, device=dev)
        kfit.write_control(ctl, fctl, hist,
                           torch.tensor(L0, dtype=f64, device=dev), start=0,
                           n_full=n_full, tol=tol)
        return ctl, fctl, hist

    all_equal = True
    for name, (L0, losses, tol) in STOP_SEQUENCES.items():
        kern, plain = control(L0, len(losses), tol), \
            control(L0, len(losses), tol)
        ran, go = 0, True
        while go and ran < len(losses):
            loss = torch.tensor(losses[ran], dtype=f64, device=dev)
            kfit.stop_rule(*kern, loss)
            go, rem = kfit.stop_rule_ref(*plain, loss)
            go, ran = bool(go), ran + 1
        if bool(rem):
            loss = torch.tensor(0.5, dtype=f64, device=dev)
            kfit.stop_rule(*kern, loss, kfit.REMAINDER)
            kfit.stop_rule_ref(*plain, loss, kfit.REMAINDER)
        torch.cuda.synchronize()
        want = host_rule_stop(L0, losses, tol)
        equal = (torch.equal(kern[0][:4], plain[0][:4])
                 and bits_equal(torch, kern[1].view(torch.int64),
                                plain[1].view(torch.int64))
                 and bits_equal(torch, kern[2].view(torch.int64),
                                plain[2].view(torch.int64)))
        all_equal = all_equal and equal
        check(equal and ran == (len(losses) if want is None else want + 1),
              f"fit_loop {name}: stop_rule_kernel equals stop_rule_ref bit "
              f"for bit (ctl {kern[0][:4].tolist()}, history "
              f"{kern[2].tolist()}), stops after block {ran} as the host "
              f"loop's rule ({want})")
    # times: the eager kernel and its plain version on a long history
    loss = torch.tensor(1.0, dtype=f64, device=dev)
    bufs = control(1.0, 100000, 0.0)
    ms = time_ms(lambda: kfit.stop_rule(*bufs, loss), reps=50)
    dms = device_ms(lambda: kfit.stop_rule(*bufs, loss), reps=50)
    bufs = control(1.0, 100000, 0.0)
    plain_ms = time_ms(lambda: kfit.stop_rule_ref(*bufs, loss), reps=50)
    # inside a fit graph: an eval block of one kernel, 2000 blocks
    from pycmf_tpu_torch.solvers.common import fit_stream

    x = torch.zeros((), dtype=f64, device=dev)
    ctl, fctl, hist = control(1.0, 2000, 0.0)
    with fit_stream(dev):
        x.add_(1.0)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, stream=torch.cuda.current_stream()):
            loss.copy_(x.mul_(1.0))
        fg = kfit.FitGraph(g.raw_cuda_graph(), 0, ctl, fctl, loss, loss)
        per_block = []
        for _ in range(3):
            kfit.write_control(ctl, fctl, hist, loss, start=0, n_full=2000,
                               tol=0.0)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fg.launch()
            b.record()
            b.synchronize()
            per_block.append(1e3 * a.elapsed_time(b) / 2000)
        blocks = int(ctl[0])
        fg.close()
    check(blocks == 2000, f"fit_loop: the fit graph ran {blocks} of 2000 "
          f"blocks")
    # each call reads i, n_full, stop, the history's address, tol, L0,
    # prev and the loss, and writes i, stop, prev and one history slot
    b_ms, by = bound(12 * 8, 0.0, 1.0)
    rec = dict(max_abs_err=0.0 if all_equal else math.inf, ms=ms,
               device_ms=dms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=None, graph_us_per_block=min(per_block),
               graph_us_per_block_all=per_block, nodes=fg.nodes)
    log(f"  fit_loop: stop_rule {ms:.4f} ms per eager call ({dms:.4f} on "
        f"the device), plain {plain_ms:.4f} ms, bound {b_ms:.2e} ms; in a fit "
        f"graph {min(per_block):.3f} device µs per block (one-kernel block, "
        f"{per_block})")
    return {"fit_loop": rec}


# Random123's known-answer vectors for Threefry-2x32 (JAX's random_test.py
# takes them): key, counter, output
THREEFRY_KNOWN = (
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)))
THREEFRY_N = (1, 2, 4097, 30000, 804414)
# integer operations of one hash (a thread's): 20 rounds of add, rotate
# and xor, five injections of three adds, the key schedule's xors
THREEFRY_OPS = 82
# jax.random.choice(fold_in(PRNGKey(0), 0), q, (s,), replace=False) with
# JAX 0.9 (threefry2x32, partitionable) on the CPU: the first 8 indices and
# the sum of all s
CHOICE_DIGESTS = {
    (11314, 2829): ((4974, 8213, 867, 4659, 2012, 6936, 8142, 3486),
                    16122259),
    (30000, 7500): ((7709, 25523, 24448, 14183, 3980, 15696, 2601, 26486),
                    111959153),
}


def threefry_phase(check, torch):
    """threefry_kernel (csrc/threefry.cu) against its plain version on the
    card, bit for bit: the three known-answer vectors; n in THREEFRY_N in
    each form (xor bits, pairs, the derived key read from a device
    counter, a counter start past 2^32); then choice_without_replacement
    on the card against CHOICE_DIGESTS (computed with JAX) and against the
    same draw on the CPU (the plain version); and a graph of two sampled
    steps' key schedule and draws (step_keys, term_key, draw_columns, the
    counter's advance): its node types must all be ones a conditional
    body takes (fit_loop.refused_node), and its replays must draw what
    eager steps from the same counter draw. Times: CUDA events around one
    call (the host's wrapper included) and device alone, the plain
    version's, the bound (the outputs' bytes, THREEFRY_OPS integer
    operations per output at the card's 67 T operations/s outside the
    tensor cores), and one whole draw."""
    import numpy as np

    from pycmf_tpu_torch.ops import random as trandom
    from pycmf_tpu_torch.ops.kernels import fit_loop as kfit
    from pycmf_tpu_torch.ops.kernels import threefry as kthree
    from pycmf_tpu_torch.solvers.common import fit_stream
    from pycmf_tpu_torch.solvers.newton import draw_columns, term_key

    dev = torch.device("cuda", torch.cuda.current_device())
    i64 = torch.int64
    for key, ctr, want in THREEFRY_KNOWN:
        got = kthree.threefry_bits(torch.tensor(key, dtype=i64, device=dev),
                                   1, start=(ctr[0] << 32) | ctr[1],
                                   form=kthree.PAIRS)[0].tolist()
        check(tuple(got) == want,
              f"threefry known answer: key {key[0]:#x} {key[1]:#x}, counter "
              f"{ctr[0]:#x} {ctr[1]:#x} -> {got[0]:#x} {got[1]:#x} (want "
              f"{want[0]:#x} {want[1]:#x})")
    rs = np.random.RandomState(SEED)
    key = torch.tensor(rs.randint(0, 2 ** 32, 2).astype(np.int64), device=dev)
    base = torch.tensor(123456, dtype=i64, device=dev)
    forms = {"bits": {}, "pairs": dict(form=kthree.PAIRS),
             "sort_keys": dict(form=kthree.SORT_KEYS),
             "derived": dict(base=base, offset=7),
             "derived_pairs_past_2^32": dict(base=base, offset=3,
                                              form=kthree.PAIRS,
                                              start=2 ** 32 - 5)}
    bad = []
    for n in THREEFRY_N:
        for name, kw in forms.items():
            if not torch.equal(kthree.threefry_bits(key, n, **kw),
                               kthree.threefry_bits_ref(key, n, **kw)):
                bad.append((n, name))
    torch.cuda.synchronize()
    check(not bad, f"threefry: the kernel equals threefry2x32_ref bit for "
          f"bit at n {THREEFRY_N} in forms {list(forms)} (unequal: {bad})")
    rec = {}
    for n in (30000, 804414):
        def kern():
            return kthree.threefry_bits(key, n)

        def plain():
            return kthree.threefry_bits_ref(key, n)
        b_ms, by = bound(8 * n + 16, THREEFRY_OPS * n, F32_FLOPS)
        rec[f"threefry[{n}]"] = dict(
            max_abs_err=0.0 if not bad else math.inf,
            ms=time_ms(kern, reps=20), device_ms=device_ms(kern, reps=20),
            plain_ms=time_ms(plain, reps=5), bound_ms=b_ms,
            bound_by="bytes" if by == "bytes" else "operations",
            library_ms=None)
        r = rec[f"threefry[{n}]"]
        log(f"  threefry n={n}: {r['ms']:.4f} ms per call ({r['device_ms']:.4f}"
            f" on the device), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.2e} ms ({by})")
    small = lambda: kthree.threefry_bits(key, 3, base=base,  # noqa: E731
                                         offset=1, form=kthree.PAIRS)
    rec["threefry[step_keys]"] = dict(ms=time_ms(small, reps=50),
                                      device_ms=device_ms(small, reps=50))
    k0 = trandom.fold_in(trandom.prng_key(0, dev), 0)
    for (q, s), (first, total) in CHOICE_DIGESTS.items():
        idx = trandom.choice_without_replacement(k0, q, s)
        cpu = trandom.choice_without_replacement(k0.cpu(), q, s)
        ok = (tuple(idx[:8].tolist()) == first and int(idx.sum()) == total
              and torch.equal(idx.cpu(), cpu))
        draw = lambda: trandom.choice_without_replacement(  # noqa: E731
            k0, q, s)
        r = rec[f"choice[{q},{s}]"] = dict(
            equal=ok, ms=time_ms(draw, reps=20),
            device_ms=device_ms(draw, reps=20),
            rounds=trandom.shuffle_rounds(q))
        check(ok, f"choice_without_replacement({q}, {s}) on the card: first "
              f"8 {idx[:8].tolist()} and sum {int(idx.sum())} == JAX's "
              f"{list(first)}, {total}; equal to the CPU's draw")
        log(f"  choice({q}, {s}): {r['ms']:.4f} ms per draw "
            f"({r['device_ms']:.4f} on the device), {r['rounds']} rounds")
    # two sampled steps' keys and draws in a graph, as a cached eval block
    # holds them
    q, s = 11314, 2829
    stream = trandom.KeyStream.start(trandom.prng_key(SEED, dev))
    out = torch.zeros(2, s, dtype=i64, device=dev)

    def steps():
        for i in range(2):
            kU, _, kV = stream.step_keys(i)
            out[i].copy_(draw_columns(term_key(kV, 0, 1), q, s))
        stream.advance(2)
    with fit_stream(dev):
        steps()   # eager: iterations 0 and 1
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g, stream=torch.cuda.current_stream()):
            steps()
        nodes, refused = kfit.refused_node(g.raw_cuda_graph(), dev.index)
        replayed = []
        for _ in range(2):   # iterations 2-3, then 4-5
            g.replay()
            replayed.append(out.clone())
        torch.cuda.synchronize()
    eager = trandom.KeyStream.start(trandom.prng_key(SEED, dev))
    eager.advance(2)
    same = True
    for r in replayed:
        for i in range(2):
            kU, _, kV = eager.step_keys(i)
            same = same and torch.equal(
                r[i], draw_columns(term_key(kV, 0, 1), q, s))
        eager.advance(2)
    check(refused is None and same and int(stream.it) == 6,
          f"threefry: a graph of two sampled steps' draws holds {nodes} "
          f"nodes, none a conditional body refuses (refused: "
          f"{kfit.NODE_TYPES.get(refused, refused)}); its replays draw what "
          f"eager steps from the device counter draw ({same}), the counter "
          f"at {int(stream.it)} of 6")
    rec["threefry_graph"] = dict(nodes=nodes, refused=refused, equal=same)
    g.reset()
    return rec


def csr_bytes(A, kw_in: int, kw_out: int) -> float:
    """Bytes a CSR product must move: the CSR arrays (values, int32 column
    indices and row pointers; the kernel's row ids are its own design, not
    the function's), the dense input B (kw_in floats per column of A) and
    the output (kw_out floats per row of A)."""
    p, q = A.shape
    return (A.nnz * (A.data.element_size() + 4) + 4.0 * (p + 1)
            + 4.0 * q * kw_in + 4.0 * p * kw_out)


def sparse_phase(check, torch):
    """Phase 3, K6-K11: csr_spmm (A and Aᵀ) and csr_rowdots on the 20NG
    surrogate and on an RCV1-v2-shaped surrogate, bell_spmm on path F's
    block-structured X and on Xᵀ (both layouts path F launches it on),
    fused_mu_update at V's shapes; each against its
    plain version on the same inputs widened to float64 (relative Frobenius
    <= 1e-5: the plain version in float32 sums a row of 8e5 nonzeros of the
    RCV1 shape with atomics, in no fixed order, and is itself 5e-5 off),
    two calls bitwise equal; the plain version's time is taken in float32.
    Then the fill at which bell_spmm and csr_spmm take equal device time
    on the same block-structured matrix (the BlockEll layout's
    BELL_MIN_FILL). Device time alone: both layouts pay the same host time
    per call, as large as bell_spmm's device time, and a crossover taken
    with it swings between runs with the host's noise."""
    import numpy as np
    import scipy.sparse as sp

    from pycmf_tpu_torch.ops import sparse
    from pycmf_tpu_torch.ops.kernels import bell, mu_update, spmm
    from pycmf_tpu_torch.utils.datasets import (block_sparse_matrix,
                                                synthetic_20ng,
                                                synthetic_rcv1)

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 2)
    rec = {}

    def factor(n):
        return torch.from_numpy(np.abs(rng.randn(n, K)).astype(np.float32)
                                ).to(dev)

    def hold(tag, fn, ref, nbytes, flops, library=None, reps=10, **extra):
        """ref(dtype): the plain version with its float inputs at dtype."""
        out = fn()
        again = fn()
        torch.cuda.synchronize()
        want = ref(torch.float64)
        torch.cuda.synchronize()
        e = rel_fro(out, want)
        check(e <= 1e-5, f"{tag} rel Frobenius {e:.3g} <= 1e-5")
        check(bool(torch.equal(out, again)), f"{tag} two calls bitwise equal")
        bms, bby = bound(nbytes, flops, F32_FLOPS)
        ms = time_ms(fn, reps=reps)
        pms = time_ms(lambda: ref(torch.float32), reps=max(3, reps // 2))
        lib = lib_dev = None
        if library is not None:
            lib = time_ms(library, reps=reps)
            lib_dev = device_ms(library)
        dev_ms = device_ms(fn)
        log(f"  {tag} kernel {ms:.4f} ms, plain {pms:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
            f"{bms:.4f} ms ({bby}); device time alone: kernel {dev_ms:.4f} "
            f"ms, library "
            f"{'none' if lib_dev is None else f'{lib_dev:.4f} ms'}"
            + "".join(f", {k} {v:.4g}" for k, v in extra.items()))
        rec[tag] = dict(max_abs_err=float((out - want).abs().max()), ms=ms,
                        plain_ms=pms, bound_ms=bms, bound_by=bby,
                        library_ms=lib, device_ms=dev_ms,
                        library_device_ms=lib_dev, **extra)
        return ms

    def library_mm(A, B):
        """torch.sparse.mm on the same CSR (values widened to float32:
        the library takes no bf16 x f32 product)."""
        T = torch.sparse_csr_tensor(A.indptr, A.indices, A.data.float(),
                                    size=A.shape)
        return lambda: torch.sparse.mm(T, B)

    def library_bsr(L, B):
        """torch.sparse.mm on the same blocks as a BSR tensor (B padded to
        whole blocks), or None where this PyTorch build has no such
        product on the card."""
        nrb = L.bptr.numel() - 1
        ncb = -(-L.shape[1] // bell.BLOCK)
        T = torch.sparse_bsr_tensor(L.bptr, L.bcols, L.blocks,
                                    size=(nrb * bell.BLOCK, ncb * bell.BLOCK))
        Bp = B.new_zeros((ncb * bell.BLOCK, B.shape[1]))
        Bp[:B.shape[0]] = B
        try:
            torch.sparse.mm(T, Bp)
        except (RuntimeError, NotImplementedError) as e:
            log(f"  BSR product not available: {str(e)[:200]}")
            return None
        return lambda: torch.sparse.mm(T, Bp)

    # edge cases at small shapes: every k the kernels instantiate apart, and
    # k > 32 in 32-column slices (a full slice, a full and a ragged one);
    # leading, interior and trailing runs of empty rows (the CSR walk zeroes
    # them itself); a row crossing many chunks; fewer nonzeros than one
    # chunk; rows ending exactly on a 16-nonzero chunk or a 4-nonzero step;
    # a row block with more stored blocks than one segment and one holding
    # only the zero filler block; row and column counts off the 128 grid
    d = sp.random(300, 200, density=0.05, format="lil", random_state=rng)
    d[3, :] = rng.rand(200)          # 200 nonzeros: many chunks
    d[0:3, :] = 0                    # leading empty rows
    d[10:40, :] = 0                  # interior
    d[293:, :] = 0                   # trailing
    tiny = rng.rand(5, 7) * (rng.rand(5, 7) < 0.4)
    tiny[0, 0] = 1.0
    wide = sp.random(260, 1100, density=0.02, format="lil", random_state=rng)
    wide[5, :] = rng.rand(1100)      # row block 0: 9 blocks, 3 segments
    wide[128:256, :] = 0             # row block 1: the filler block only
    lens = np.tile([16, 16, 4, 12, 0, 32, 8, 4, 4, 0, 0, 16, 5, 11, 16], 3)
    aligned = sp.csr_matrix(
        (rng.rand(int(lens.sum())) + 0.5,
         np.concatenate([np.sort(rng.choice(64, n, replace=False))
                         for n in lens]).astype(np.int32),
         np.r_[0, np.cumsum(lens)]), shape=(lens.size, 64))
    edge = (("", sp.csr_matrix(d)), (" tiny", sp.csr_matrix(tiny)),
            (" wide", sp.csr_matrix(wide)), (" aligned", aligned))
    for k in (1, 7, 20, 32, 33, 64, 100):
        for suffix, Xh in edge:
            tag = f"edge k={k}{suffix}"
            for xname in ("bfloat16", "float32"):
                dt = getattr(torch, xname)
                C = sparse.csr_from_scipy(Xh, dt, dev)
                L = bell.bell_from_scipy(Xh, dt, dev)
                Mf = torch.from_numpy(rng.rand(Xh.shape[0], k).astype(
                    np.float32)).to(dev)
                B = torch.from_numpy(rng.rand(Xh.shape[1], k).astype(
                    np.float32)).to(dev)
                S = torch.from_numpy(rng.rand(k, k).astype(np.float32)
                                     ).to(dev)
                for name, call, want in (
                        ("csr_spmm", lambda: spmm.csr_spmm(C, B),
                         spmm.csr_spmm_ref(C, B.double())),
                        ("csr_rowdots", lambda: spmm.csr_rowdots(C, Mf, B),
                         spmm.csr_rowdots_ref(C, Mf.double(), B.double())),
                        ("bell_spmm", lambda: bell.bell_spmm(L, B),
                         bell.bell_spmm_ref(L, B.double())),
                        ("fused_mu_update",
                         lambda: mu_update.fused_mu_update(Mf, S, Mf, 0.1,
                                                           0.2, 1e-10),
                         mu_update.fused_mu_update_ref(
                             Mf.double(), S.double(), Mf.double(), 0.1, 0.2,
                             1e-10))):
                    got = nan_filled(call)
                    again = call()
                    torch.cuda.synchronize()
                    e = rel_fro(got, want)
                    check(e <= 1e-5 and bool(torch.equal(got, again)),
                          f"{name}[{tag}, {xname}] rel Frobenius {e:.3g} <= "
                          f"1e-5 (output and scratch NaN-filled), two calls "
                          f"bitwise equal")

    t0 = time.perf_counter()
    X20, _ = synthetic_20ng(random_state=SEED)
    Xr = synthetic_rcv1(random_state=SEED)
    log(f"phase 3: sparse surrogates in {time.perf_counter() - t0:.1f} s: "
        f"20NG {X20.shape} nnz={X20.nnz}, RCV1 {Xr.shape} nnz={Xr.nnz}, "
        f"longest row {int(np.diff(Xr.indptr).max())}")
    for shape, Xh in (("20ng", X20), ("rcv1", Xr)):
        p, q = Xh.shape
        U, V = factor(p), factor(q)
        for xname in ("bfloat16", "float32"):
            C, Ct = sparse.csr_transpose_host(Xh, getattr(torch, xname), dev)
            gather = C.nnz * K * 4.0
            for tag, A, B in ((f"csr_spmm[{shape},{xname}] X V", C, V),
                              (f"csr_spmm[{shape},{xname}] Xt U", Ct, U)):
                nb = csr_bytes(A, K, K)
                hold(tag, lambda: spmm.csr_spmm(A, B),
                     lambda dt: spmm.csr_spmm_ref(A, B.to(dt)), nb,
                     2.0 * A.nnz * K,
                     library=library_mm(A, B),
                     gather_dram_bound_ms=1e3 * (nb + gather) / HBM_BPS)
            hold(f"csr_rowdots[{shape},{xname}]",
                 lambda: spmm.csr_rowdots(C, U, V),
                 lambda dt: spmm.csr_rowdots_ref(C, U.to(dt), V.to(dt)),
                 csr_bytes(C, K, 1) + 4.0 * p * K,
                 2.0 * C.nnz * K + 2.0 * p * K,
                 gather_dram_bound_ms=1e3 * (csr_bytes(C, K, 1)
                                             + 4.0 * p * K + gather)
                 / HBM_BPS)
            del C, Ct
        # K6 at V's shape
        Mf, num = factor(q), factor(q)
        S = Mf.T @ Mf / q
        hold(f"fused_mu_update[{q}x{K}]",
             lambda: mu_update.fused_mu_update(Mf, S, num, 1e-3, 2e-3, 1e-10),
             lambda dt: mu_update.fused_mu_update_ref(
                 Mf.to(dt), S.to(dt), num.to(dt), 1e-3, 2e-3, 1e-10),
             4.0 * (3 * q * K + K * K), q * K * (2.0 * K + 5), reps=20)
        del U, V, Mf, num
    del Xr
    torch.cuda.empty_cache()

    # K7 on path F's block-structured X, and the crossover fill
    t0 = time.perf_counter()
    Xb = block_sparse_matrix(N, M, 0.15, np.random.RandomState(SEED))
    keep = np.random.RandomState(SEED + 3).rand(Xb.nnz) < 1.0 / 16
    Xthin = sp.csr_matrix((Xb.data[keep], Xb.indices[keep],
                           np.r_[0, np.cumsum(keep)][Xb.indptr]),
                          shape=Xb.shape)
    log(f"phase 3: block-structured X {Xb.shape} nnz={Xb.nnz} and its "
        f"1/16 thinning nnz={Xthin.nnz} in {time.perf_counter() - t0:.1f} s")
    V, U = factor(M), factor(N)
    cross = {}
    for xname in ("bfloat16", "float32"):
        dt = getattr(torch, xname)
        for fname, Xh, B in (("full", Xb, V), ("fullT", Xb.T, U),
                             ("thin", Xthin, V)):
            L = bell.bell_from_scipy(Xh, dt, dev)
            nb = (L.nbytes + 4.0 * (L.bcols.numel() + L.bptr.numel())
                  + 4.0 * (M + N) * K)
            flops = 2.0 * L.blocks.shape[0] * bell.BLOCK ** 2 * K
            tb = hold(f"bell_spmm[{fname},{xname}]",
                      lambda: bell.bell_spmm(L, B),
                      lambda dt: bell.bell_spmm_ref(L, B.to(dt)), nb, flops,
                      library=library_bsr(L, B) if xname == "float32"
                      else None,
                      fill=L.fill, blocks=float(L.blocks.shape[0]),
                      row_blocks=float(L.bptr.numel() - 1),
                      segments=float(L.segs.numel() - 1))
            if fname != "fullT":
                C = sparse.csr_from_scipy(Xh, dt, dev)
                tc = time_ms(lambda: spmm.csr_spmm(C, V))
                db = device_ms(lambda: bell.bell_spmm(L, V))
                dc = device_ms(lambda: spmm.csr_spmm(C, V))
                cross[(xname, fname)] = (db, dc, C.nnz, L.blocks.shape[0])
                log(f"  csr_spmm on the same matrix ({fname}, {xname}): "
                    f"{tc:.4f} ms; device time alone: bell_spmm {db:.4f} "
                    f"ms (was {tb:.4f} with the host's), csr_spmm {dc:.4f} ms")
                del C
            del L
    for xname in ("bfloat16", "float32"):
        tb, tc1, n1, nb1 = cross[(xname, "full")]
        _, tc2, n2, _ = cross[(xname, "thin")]
        slope = (tc1 - tc2) / (n1 - n2)
        fill = (tb - (tc1 - slope * n1)) / (slope * nb1 * bell.BLOCK ** 2)
        rec[f"crossover[{xname}]"] = dict(
            fill=fill, bell_device_ms=tb, csr_full_device_ms=tc1,
            csr_thin_device_ms=tc2)
        log(f"  crossover ({xname}): csr_spmm equals bell_spmm at fill "
            f"{fill:.4g}")
    fill = rec["crossover[bfloat16]"]["fill"]
    check(fill / 2 <= bell.BELL_MIN_FILL <= 2 * fill,
          f"BELL_MIN_FILL {bell.BELL_MIN_FILL} within a factor 2 of the "
          f"measured bf16 crossover {fill:.4g} (else re-measure it)")
    del Xb, Xthin, V, U
    torch.cuda.empty_cache()
    return rec


def per_iter(**kernels):
    """Launch minimums of a path: {name: launches per iteration}."""
    return lambda est: {k: n * est.n_iter_ for k, n in kernels.items()}


def run_fit(check, make_est, X, Y, minimums, label):
    """Fit through the estimator, after an untimed warm-up fit, with the
    launch counts set to 0 just before and read just after; check the
    losses are finite and each kernel of the path launched at least its
    minimum (minimums(est) -> {name: launches required in the fit})."""
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)

    import torch

    # warm-up, not timed: the first launch of each library kernel loads it
    make_est().set_params(max_iter=2, eval_every=1, tol=0.0).fit(X, Y)
    est = make_est()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    est.fit_transform(X, Y)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    fit_peak = torch.cuda.max_memory_allocated() / 1e9
    hist = est.loss_history_
    check(all(math.isfinite(v) for v in hist), f"{label}: finite losses")
    if est._resolve_loop(est._config(has_Y=Y is not None)) == "device":
        from pycmf_tpu_torch.solvers.common import LAST_FIT
        # one rule per eval block, and on a fit graph its gates (one, two
        # with a remainder block) per launch
        gates = (1 + bool(est.max_iter % min(est.eval_every, est.max_iter))
                 ) * LAST_FIT["graph_launches"]
        check(counts.get("fit_loop", 0) == len(hist) - 1 + gates,
              f"{label}: fit_loop's stop rule ran once per eval block, "
              f"gates apart ({counts.get('fit_loop', 0)} of "
              f"{len(hist) - 1} + {gates})")
    for kernel, need in minimums(est).items():
        got = counts.get(kernel, 0)
        check(got >= need, f"{label}: {kernel} launches {got} >= {need} "
              f"(n_iter {est.n_iter_}, {len(hist)} loss evaluations)")
    ms_iter = 1e3 * sum(est.step_times_) / est.n_iter_
    log(f"  {label}: n_iter {est.n_iter_}, final loss "
        f"{est.reconstruction_err_:.9g}, {ms_iter:.4f} ms/iter (solver "
        f"loop), fit wall {wall:.3f} s incl. ingest; launches {counts}; "
        f"peak device memory of this fit {fit_peak:.3f} GB")
    return est, dict(n_iter=est.n_iter_, loss=est.reconstruction_err_,
                     ms_per_iter=ms_iter, launches=counts, wall_s=wall,
                     blocks=list(est.step_times_), fit_peak_gb=fit_peak)


def fit_phase(check, make_est, X, Y, minimums, label, exact_loss):
    """run_fit, then check the objective along the fit.

    exact_loss(U, V, Z) is the float64 objective. The reported eval-point
    losses come from the solvers' zero-extra-pass identities, which round
    (bf16 XᵀU_new, f32 sums); monotonicity is checked on the exact
    objective at each eval point, along the same trajectory replayed as
    warm-started segments of eval_every iterations, and the replay must end
    on the fit's own factors bit for bit."""
    import numpy as np

    from pycmf_tpu_torch.utils.init import initialize_factors

    est, rec = run_fit(check, make_est, X, Y, minimums, label)
    hist = est.loss_history_
    U, V, Z = initialize_factors(
        X, Y, K, random_state=SEED, U_non_negative=est.U_non_negative,
        V_non_negative=est.V_non_negative, Z_non_negative=est.Z_non_negative)
    exact = [exact_loss(U, V, Z)]
    step = est.eval_every
    with cached_ingest():  # one ingest for the segments (path F's ~12 s)
        for done in range(0, est.n_iter_, step):
            n = min(step, est.n_iter_ - done)
            seg = make_est().set_params(max_iter=n, eval_every=n, tol=0.0)
            U, V, Z = seg.fit_transform(X, Y, U=U, V=V, Z=Z)
            exact.append(exact_loss(U, V, Z))
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
    return est, dict(rec, exact_loss=exact[-1],
                     reported_vs_exact_max_rel=dev)


def run_fit_checked(check, make_est, X, Y, minimums, absent, label,
                    exact_loss, loop):
    """run_fit, then: the kernels in ``absent`` launched no time, the fit
    ran the loop ``loop`` under 'auto', and the exact float64 objective of
    its final factors (a sampled fit's is not monotone along the fit, and
    a warm-started replay would restart its draws, so fit_phase's checks
    do not apply)."""
    from pycmf_tpu_torch.ops.kernels.policy import launch_counts

    est, rec = run_fit(check, make_est, X, Y, minimums, label)
    counts = launch_counts()
    check(all(counts.get(k, 0) == 0 for k in absent),
          f"{label}: no launch of {absent} ({counts})")
    got = est._resolve_loop(est._config(has_Y=Y is not None))
    check(got == loop, f"{label}: loop='auto' resolves to {got} ({loop})")
    rec["exact_loss"] = exact_loss(est.U_, est.V_, est.Z_)
    log(f"  {label}: exact f64 loss of the final factors "
        f"{rec['exact_loss']:.9g}")
    return est, rec


# the host's calls that start device work, as torch.profiler names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
               "cudaMemsetAsync")
REPLAY = "pycmf graph launch"


def profile_phase(torch, make_est, X, Y, label):
    """torch.profiler over the solver loop of one fit (the estimator's
    _run: ingest and init excluded). Returns, per iteration, the wall
    time under the profiler, the device time (kernels, copies and memsets
    by their device timestamps), the device launches, the device's idle
    share of the window, and the kernels by device time; per eval block,
    the host's launch calls (LAUNCH_APIS), per fit too, and under the
    device loop the graph launches (a fit graph's, or with a refused node
    the replays of its eval block) and the launch calls made inside
    each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from pycmf_tpu_torch.models.cmf import CMF
    from pycmf_tpu_torch.ops.kernels.fit_loop import FitGraph
    from pycmf_tpu_torch.solvers.common import CudaBlockGraph

    seen = {}
    run, replay, launch = CMF._run, CudaBlockGraph.replay, FitGraph.launch

    def profiled_run(self, *args):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run(self, *args)
            torch.cuda.synchronize()
            seen["wall_ms"] = 1e3 * (time.perf_counter() - t0)
        seen["prof"] = prof
        return out

    def marked(fn):
        def in_range(self):
            with record_function(REPLAY):
                fn(self)
        return in_range

    with mock.patch.object(CMF, "_run", profiled_run), \
            mock.patch.object(CudaBlockGraph, "replay", marked(replay)), \
            mock.patch.object(FitGraph, "launch", marked(launch)):
        est = make_est().fit(X, Y)
    n = est.n_iter_
    by_name, calls, replays = {}, [], []
    for e in seen["prof"].events():
        if e.name == REPLAY:  # the range also shows on the device
            if e.device_type != DeviceType.CUDA:
                replays.append((e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA:
            c = by_name.setdefault(e.name, [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us() / 1e3
        elif e.name in LAUNCH_APIS:
            calls.append(e.time_range.start)
    busy = sum(c[1] for c in by_name.values())
    launches = sum(c[0] for c in by_name.values())
    in_replay = sum(any(a <= t <= b for a, b in replays) for t in calls)
    blocks = len(est.loss_history_) - 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    out = dict(n_iter=n, wall_ms_per_iter=seen["wall_ms"] / n,
               device_ms_per_iter=busy / n,
               device_idle_share=1.0 - busy / seen["wall_ms"],
               device_launches_per_iter=launches / n,
               launch_calls_per_block=len(calls) / blocks,
               launch_calls_per_fit=len(calls),
               replays=len(replays),
               launch_calls_per_replay=(in_replay / len(replays)
                                        if replays else None),
               top_kernels=[dict(name=k[:90], launches_per_iter=c[0] / n,
                                 ms_per_iter=c[1] / n) for k, c in top])
    log(f"  {label} under torch.profiler, {n} iterations: "
        f"{out['wall_ms_per_iter']:.4f} ms/iter wall, "
        f"{out['device_ms_per_iter']:.4f} ms/iter on the device, idle share "
        f"{out['device_idle_share']:.3f}, {out['device_launches_per_iter']:.1f}"
        f" device launches/iter, {out['launch_calls_per_block']:.1f} host "
        f"launch calls per eval block ({blocks} blocks), "
        f"{out['launch_calls_per_replay']} per graph launch "
        f"({len(replays)} graph launches)")
    for t in out["top_kernels"]:
        log(f"    {t['ms_per_iter']:9.4f} ms/iter {t['launches_per_iter']:6.1f}"
            f" x/iter  {t['name']}")
    return out


def cached_ingest():
    """A patch of the estimator's ingest that builds each matrix's Coupled
    once and hands it to every later fit (the fits read it and never write
    it). The loop phase fits each path many times; ingest is outside
    ms/iter, and path F's takes ~9 s."""
    from pycmf_tpu_torch.models import cmf

    real, memo = cmf.as_coupled, {}

    def ingest(A, dtype, device, **kw):
        key = (id(A), dtype, str(device), tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = (A, real(A, dtype, device, **kw))  # A kept: its id
        return memo[key][1]

    return mock.patch.object(cmf, "as_coupled", ingest)


def fit_counted(est, X, Y):
    """est.fit(X, Y) with the launch counts set to 0 just before and the
    device loop's record (LAST_FIT) cleared: (est, counts, record)."""
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.solvers.common import LAST_FIT

    LAST_FIT.clear()
    reset_launch_counts()
    est.fit(X, Y)
    return est, launch_counts(), dict(LAST_FIT)


def entry_bytes(torch, entry) -> dict:
    """A cache entry's device memory: its buffers (``nbytes``), what a hit
    copies in (the data but the scratch, and the factors) and its graph
    pool as the caching allocator holds it."""
    pool = tuple(entry.block.graph.pool())
    return dict(
        entry_bytes=entry.nbytes,
        copy_bytes=sum(t.untyped_storage().nbytes() for t in
                       [t for t, s in entry.data if not s] + entry.statics),
        pool_bytes=sum(seg["total_size"] for seg in
                       torch.cuda.memory._snapshot()["segments"]
                       if tuple(seg["segment_pool_id"]) == pool),
        graph_nodes=entry.nodes)


def build_parts(torch):
    """A patch that times the parts of the fit that builds a cache entry,
    each between two syncs: the copies of the data and factors, the
    captures and the fit graph's build. Yields the record (ms)."""
    from pycmf_tpu_torch.ops.kernels import fit_loop as kfit
    from pycmf_tpu_torch.solvers import common as tcommon

    parts = {"copy_ms": 0.0, "capture_ms": 0.0, "graph_build_ms": 0.0}

    def timed(fn, name):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            parts[name] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    @contextmanager
    def patched():
        with mock.patch.object(tcommon, "_owned_copy", timed(
                tcommon._owned_copy, "copy_ms")), \
                mock.patch.object(tcommon.FitEntry, "_capture", timed(
                    tcommon.FitEntry._capture, "capture_ms")), \
                mock.patch.object(kfit.FitGraph, "__init__", timed(
                    kfit.FitGraph.__init__, "graph_build_ms")):
            yield parts
    return patched()


def loop_phase(check, torch, make_est, X, Y, label, bits=False, miss=False):
    """The device loop against the host loop on one path, from the
    estimator's init. An untimed host fit ingests the data first, then
    the fit cache is emptied. The key's first device fit (timed: what a
    one-off fit costs, ingest apart) runs block 1 eagerly,
    captures a graph of its own and replays it per block: no cache entry.
    The second builds the entry (timed, its copies, captures and fit graph
    build apart, each between syncs). Then two host and two device fits in
    the order H D, D H. Each device fit must find its program in the
    cache: no capture and no eager block, one launch of the fit graph (a
    sampled fit's too: its draws keyed on the entry's device counter).
    Each must agree with the host fit beside it:
    the same n_iter_ and loss_iters_, each loss within 1e-6 relative, the
    factors within phase 3's relative Frobenius bar of 1e-5, the same
    launches of every kernel (fit_loop's apart: one per eval block, and on
    a fit graph its gates, none on the host loop), and with ``bits`` the
    same bits. The factors the first device hit returned (torch tensors,
    from run_mu or run_newton) must not change in the second, nor share
    memory with the cache. With ``miss``: a device fit with another alpha
    misses and captures anew. Each device fit's peak device memory above
    what was allocated before it. Then one fit of each loop under
    torch.profiler (the device loop's a cache hit). Returns the record of
    both loops."""
    import numpy as np

    from pycmf_tpu_torch.models import cmf as tcmf
    from pycmf_tpu_torch.solvers.common import (clear_fit_cache,
                                                fit_cache_entries)

    returned, run_ms = [], []

    def keep(run):
        def kept(*args, **kw):
            out = run(*args, **kw)
            returned.append(out[:3])
            return out
        return kept

    def timed(run):  # the solver's whole fit, L0 included, on both loops
        def whole(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(self, *args)
            torch.cuda.synchronize()
            run_ms.append(1e3 * (time.perf_counter() - t0) / out[3])
            return out
        return whole

    def device_fit(**kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        est, counts, info = fit_counted(
            make_est().set_params(loop="device", **kw), X, Y)
        info.update(ms_per_iter=1e3 * sum(est.step_times_) / est.n_iter_,
                    run_ms_per_iter=run_ms[-1],
                    extra_peak_gb=(torch.cuda.max_memory_allocated()
                                   - base) / 1e9)
        return est, counts, info

    # the data ingested (cached_ingest) and its memory settled by a host
    # fit first, so the first device fit is timed on data ingested earlier
    # (chip_ab --phase loops times it after a fresh ingest too)
    make_est().set_params(loop="host").fit(X, Y)
    clear_fit_cache()
    fits = {"host": [], "device": []}
    with mock.patch.object(tcmf, "run_mu", keep(tcmf.run_mu)), \
            mock.patch.object(tcmf, "run_newton", keep(tcmf.run_newton)), \
            mock.patch.object(tcmf.CMF, "_run", timed(tcmf.CMF._run)):
        est, _, first = device_fit()
        full = est.n_iter_ // min(est.eval_every, est.max_iter)
        check(not first["hit"] and first["eager_blocks"] == 1
              and first["captures"] == int(full > 1)
              and first["graph_launches"] == 0 and not fit_cache_entries(),
              f"{label}: the key's first device fit misses, runs one eager "
              f"block, captures a graph of its own when a second block "
              f"runs and keeps no cache entry ({first})")
        with build_parts(torch) as parts:
            est, _, build = device_fit()
        build.update(parts)
        check(not build["hit"] and build["eager_blocks"] == 0
              and build["captures"] >= 1 and len(fit_cache_entries()) == 1
              and (build["graph_launches"], build["replays"]) == (1, 0),
              f"{label}: the key's second device fit builds the cache entry "
              f"and runs on it ({build})")
        for order in (("host", "device"), ("device", "host")):
            for loop in order:
                if loop == "device":
                    est, counts, info = device_fit()
                else:
                    est, counts, info = fit_counted(
                        make_est().set_params(loop=loop), X, Y)
                fits[loop].append(dict(
                    est=est, counts=counts, info=info,
                    factors=returned[-1], run_ms=run_ms[-1],
                    ms=1e3 * sum(est.step_times_) / est.n_iter_))
                if loop == "device" and len(fits["device"]) == 1:
                    snapshot = [t.clone() for t in returned[-1]]
        (entry,) = fit_cache_entries()
        sizes = entry_bytes(torch, entry)
        theirs = {t.untyped_storage().data_ptr() for t in entry.statics}
        kept_ok = all(bits_equal(torch, a, b) for a, b in zip(
            fits["device"][0]["factors"], snapshot)) and not theirs & {
            t.untyped_storage().data_ptr()
            for t in fits["device"][0]["factors"]}
        check(kept_ok, f"{label}: the second device hit leaves the factors "
              f"the first returned as they were, and none is a cache "
              f"entry's buffer")
        if miss:
            alpha = make_est().alpha + 1e-3
            oest, _, other = device_fit(alpha=alpha)
            ofull = oest.n_iter_ // min(oest.eval_every, oest.max_iter)
            check(not other["hit"] and other["captures"] == int(ofull > 1)
                  and other["eager_blocks"] == 1,
                  f"{label}: a device fit with alpha={alpha:g} misses and "
                  f"captures anew ({other})")
    gaps, fro, bit = [], [], True
    for h, d in zip(fits["host"], fits["device"]):
        he, de, info = h["est"], d["est"], d["info"]
        blocks = len(de.loss_history_) - 1
        rem = de.max_iter % min(de.eval_every, de.max_iter)
        schedule = (info["hit"] and info["captures"] == 0
                    and info["eager_blocks"] == 0
                    and (info["graph_launches"], info["replays"]) == (1, 0))
        check(schedule and not h["info"],
              f"{label}: the device fit hits the cache: no capture, no eager "
              f"block, one graph launch ({info}); the host fit uses no "
              f"program ({h['info']})")
        check(he.n_iter_ == de.n_iter_ and he.loss_iters_ == de.loss_iters_,
              f"{label}: device loop n_iter {de.n_iter_}, eval points "
              f"{de.loss_iters_} == host loop's {he.n_iter_}, "
              f"{he.loss_iters_}")
        gaps.append(max(abs(a - b) / abs(a) for a, b in
                        zip(he.loss_history_, de.loss_history_)))
        bit = bit and he.loss_history_ == de.loss_history_ and all(
            np.array_equal(getattr(he, f), getattr(de, f))
            for f in ("U_", "V_", "Z_"))
        fro.append(factor_gap([de.U_, de.V_, de.Z_], [he.U_, he.V_, he.Z_]))
        dc, hc = ({k: v for k, v in c.items() if k != "fit_loop"}
                  for c in (d["counts"], h["counts"]))
        rules = blocks + 1 + bool(rem)
        check(hc == dc and d["counts"].get("fit_loop") == rules
              and not h["counts"].get("fit_loop"),
              f"{label}: launch counts, device loop {d['counts']} == host "
              f"loop {h['counts']} but fit_loop, {rules} on the device loop "
              f"(one per eval block, and the fit graph's gates)")
    gap, far = float(np.max(gaps)), float(np.max(fro))
    check(gap <= 1e-6 and far <= 1e-5 and (bit or not bits),
          f"{label}: device vs host loop, loss max rel gap {gap:.3g} "
          f"<= 1e-6, factors rel Frobenius max {far:.3g} <= 1e-5, "
          f"bit for bit equal: {bit}" + (" (required)" if bits else ""))
    rec = dict(loss_max_rel_gap=gap, factor_rel_fro=far,
               bit_equal=bit, n_iter=fits["host"][0]["est"].n_iter_,
               eval_every=fits["host"][0]["est"].eval_every)
    for loop, runs in fits.items():
        r = dict(ms_per_iter=min(f["ms"] for f in runs),
                 ms_per_iter_all=[f["ms"] for f in runs],
                 run_ms_per_iter=min(f["run_ms"] for f in runs),
                 run_ms_per_iter_all=[f["run_ms"] for f in runs])
        r["profile"] = profile_phase(
            torch, lambda: make_est().set_params(loop=loop), X, Y,
            f"{label}, {loop} loop")
        rec[loop] = r
    d, h = rec["device"], rec["host"]
    d.update(first_fit_ms_per_iter=first["ms_per_iter"],
             first_fit_run_ms_per_iter=first["run_ms_per_iter"],
             first_fit_extra_peak_gb=first["extra_peak_gb"],
             build_run_ms_per_iter=build["run_ms_per_iter"],
             build_parts_ms={k: build[k] for k in parts},
             build_extra_peak_gb=build["extra_peak_gb"],
             hit_extra_peak_gb=max(f["info"]["extra_peak_gb"]
                                   for f in fits["device"]), **sizes)
    log(f"  {label}: whole fit (the solver's call, L0 included) host loop "
        f"{h['run_ms_per_iter']:.4f} ms/iter, device loop on a cache hit "
        f"{d['run_ms_per_iter']:.4f}, first fit of the key "
        f"{d['first_fit_run_ms_per_iter']:.4f}, the fit that builds the "
        f"entry {d['build_run_ms_per_iter']:.4f} (parts between syncs, ms: "
        f"{d['build_parts_ms']}); step_times host {h['ms_per_iter']:.4f}, "
        f"hit {d['ms_per_iter']:.4f}, first {d['first_fit_ms_per_iter']:.4f}"
        f" (each fit, whole: host {h['run_ms_per_iter_all']}, hit "
        f"{d['run_ms_per_iter_all']}); peak above the fit's start: first "
        f"{d['first_fit_extra_peak_gb']:.4f} GB, build "
        f"{d['build_extra_peak_gb']:.4f}, hit {d['hit_extra_peak_gb']:.4f}; "
        f"entry {d['entry_bytes'] / 1e6:.1f} MB (pool "
        f"{d['pool_bytes'] / 1e6:.1f}), a hit copies "
        f"{d['copy_bytes'] / 1e6:.1f} MB, {d['graph_nodes']} graph nodes; "
        f"device ms/iter {h['profile']['device_ms_per_iter']:.4f} / "
        f"{d['profile']['device_ms_per_iter']:.4f}, idle share "
        f"{h['profile']['device_idle_share']:.3f} / "
        f"{d['profile']['device_idle_share']:.3f}, host launch calls per "
        f"fit {h['profile']['launch_calls_per_fit']} / "
        f"{d['profile']['launch_calls_per_fit']}, graph launches per fit "
        f"{d['profile']['replays']}")
    return rec


def default_dtype_fits(check, torch, CMF, X, Y, mu_kw, a_kw, common32):
    """The MU cell and path A with the estimator's defaults (dtype
    'float32', data_dtype unset: the dense X is float32, so K1 and K2 take
    their f32 form, the cluster route), from an emptied fit cache, through
    run_fit_checked (the device loop under 'auto', the exact float64 loss
    of the final factors): X reached the kernel as float32 on the cluster
    route on every call, and K1 (MU) or K2 (path A) launched once per
    iteration. Returns the two fits' records."""
    import numpy as np

    from baselines import numpy_cmf
    from pycmf_tpu_torch.ops.kernels import mu_fused, newton_fused
    from pycmf_tpu_torch.solvers.common import clear_fit_cache

    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    f32 = {}
    for key, kw, mod, kernel, mins, loss in (
            ("mu", mu_kw, mu_fused, "fused_mu_u_pass",
             per_iter(fused_mu_u_pass=1, fused_mu_update=2),
             lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z)),
            ("path_a", a_kw, newton_fused, "fused_newton_linear_u_pass",
             per_iter(fused_newton_linear_u_pass=1, sigmoid_gh_pass=1,
                      sigmoid_phi_pass=1, batched_spd_solve=2),
             lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z,
                                            y_link="sigmoid"))):
        real, seen = getattr(mod, kernel), set()

        def spy(A, U, *args, _real=real, _seen=seen, **kw_):
            _seen.add((str(A.dtype).replace("torch.", ""),
                       mu_fused.plan_for(A, U.shape[1]).clusters > 0))
            return _real(A, U, *args, **kw_)
        clear_fit_cache()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(mod, kernel, spy):
            est, r = run_fit_checked(
                check, lambda: CMF(**kw, **common32), X, Y, mins,
                (kernel + "_fp8",), f"{key} fit, the default dtype", loss,
                "device")
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        got = r["launches"].get(kernel, 0)
        params = est.get_params()
        check((params["dtype"], params["data_dtype"]) == ("float32", None)
              and seen == {("float32", True)} and got == est.n_iter_,
              f"{key} fit, the default dtype ({params['dtype']}, "
              f"data_dtype {params['data_dtype']}): {kernel} took X as "
              f"{sorted(seen)} (dtype, cluster route), {got} launches in "
              f"{est.n_iter_} iterations (one each); peak device memory "
              f"{r['peak_mem_gb']:.3f} GB")
        f32[key] = r
    clear_fit_cache()
    return f32


def card_sigmoid_loss(torch, X, Y):
    """Exact float64 objective of a sigmoid-X, sigmoid-Y fit, taken on the
    card in row blocks (X, Y: host scipy/NumPy 0/1 matrices)."""
    import numpy as np
    import scipy.sparse as sp

    dev = torch.device("cuda")
    Xd = torch.from_numpy(X.toarray() if sp.issparse(X) else np.asarray(X))
    Xd = Xd.to(device=dev, dtype=torch.float64)
    Yd = torch.from_numpy(np.asarray(Y, dtype=np.float64)).to(dev)

    def term(A, Mf, Bf):
        s = 0.0
        for i in range(0, A.shape[0], 2048):
            r = A[i:i + 2048] - torch.sigmoid(Mf[i:i + 2048] @ Bf.T)
            s += float((r * r).sum())
        return 0.5 * s

    def loss(U, V, Z):
        u, v, z = (torch.from_numpy(np.asarray(a, dtype=np.float64)).to(dev)
                   for a in (U, V, Z))
        return term(Xd, u, v) + term(Yd, v, z)

    return loss


def repeatable_segment_sum(vals, A):
    """``ops/sparse._segment_sum`` (per-row sums of per-nonzero values of a
    CSR A) in a fixed order: ``torch.segment_reduce`` over A's row
    pointers. On the card ``index_add_`` adds with atomics in no fixed
    order, so two plain steps of a CSR path part in their last bits and,
    at a line search's near tie, in a row's step. It syncs with the host,
    so it serves host-loop fits only (step_agreement)."""
    import torch

    return torch.segment_reduce(vals, "sum", offsets=A.indptr.long(), axis=0)


def step_agreement(check, make_est, X, Y, k, plain, label, exact_loss,
                   steps, factor_bar):
    """Kernel path against plain path on the card, one step at a time from
    shared factors: at each of `steps` steps both paths start from the same
    factors (the kernel path's after the step before; the first from the
    estimator's init) and run one iteration (a warm-started fit of
    max_iter=1). Two bars hold at every step: the factors U, V, Z of the two
    results agree to `factor_bar` in relative Frobenius norm, phase 3's bar
    for what the step's kernels return (1e-4 for K1's U_new and K6 on the MU
    paths; 1e-3 on the Newton paths, K2's numV and K5's d), and their exact
    float64 objectives agree to 1e-6 relative (the clean runs read at most
    6.3e-8: PERF.md §6). The loss alone would not do: near the fit it is
    flat to first order in the factors. Over 20 free iterations the two
    paths of a dense bf16 fit part by 1e-4 to 1e-3 whatever the kernels
    (bf16 rounding of U_new and line-search decisions amplify f32 summation
    order: PERF.md §6), which measures that chaos, not the kernels; one
    step from shared factors measures the kernels. Returns the largest loss
    gap. A CSR path's per-row sums (its ingest's row norms on both sides,
    the plain products) take repeatable_segment_sum, so that each side
    repeats itself bit for bit."""
    import numpy as np

    from pycmf_tpu_torch.ops import sparse as tsparse
    from pycmf_tpu_torch.utils.init import initialize_factors

    est = make_est()
    U, V, Z = initialize_factors(
        X, Y, k, random_state=SEED, U_non_negative=est.U_non_negative,
        V_non_negative=est.V_non_negative, Z_non_negative=est.Z_non_negative)
    gaps, dev = [], []
    for _ in range(steps):
        def one():  # the host loop: patched wrappers are called every fit
            with mock.patch.object(tsparse, "_segment_sum",
                                   repeatable_segment_sum):
                return make_est().set_params(
                    max_iter=1, eval_every=1, tol=0.0, loop="host"
                ).fit_transform(X, Y, U=U, V=V, Z=Z)
        got = one()
        with ExitStack() as patches:
            for fn, mod in plain.items():
                patches.enter_context(mock.patch.object(
                    mod, fn, getattr(mod, fn + "_ref")))
            want = one()
        lk, lp = exact_loss(*got), exact_loss(*want)
        gaps.append(abs(lk - lp) / abs(lp))
        dev.append(factor_gap(got, want))
        U, V, Z = got
    worst, far = float(np.max(gaps)), float(np.max(dev))
    check(worst <= 1e-6 and far <= factor_bar,
          f"{label}: kernel vs plain step from shared factors, {steps} "
          f"steps, exact f64 loss rel gap max {worst:.3g} <= 1e-6 (per step "
          f"{[float(f'{g:.3g}') for g in gaps]}), factors rel Frobenius max "
          f"{far:.3g} <= {factor_bar:g} (per step "
          f"{[float(f'{g:.3g}') for g in dev]})")
    return worst


_RCV1 = {}


def rcv1_surrogate():
    """The RCV1-v2-shaped surrogate (utils/datasets.py:synthetic_rcv1,
    47236 x 804414, 60.7M nonzeros), drawn once per run (~20 s)."""
    if "X" not in _RCV1:
        from pycmf_tpu_torch.utils.datasets import synthetic_rcv1

        _RCV1["X"] = synthetic_rcv1(random_state=SEED)
    return _RCV1["X"]


@contextmanager
def ingested_layouts():
    """A patch of the estimator's ingest that records, for each matrix it
    ingests, the geometry of the chunked layout the fit got (chunks C of R
    rows, each padded to L entries, and the padding ratio C·L / nnz), or
    None for any other layout. Enter it before cached_ingest, which then
    wraps it (one record per matrix, however many fits read it)."""
    from pycmf_tpu_torch.models import cmf
    from pycmf_tpu_torch.ops.chunked import is_chunked

    real, seen = cmf.as_coupled, []

    def ingest(A, *a, **kw):
        out = real(A, *a, **kw)
        ck = out.A
        seen.append(dict(chunks=ck.n_chunks, chunk_rows=ck.chunk_rows,
                         L=int(ck.data.shape[1]), nnz=ck.nnz,
                         padding_ratio=ck.capacity / ck.nnz)
                    if is_chunked(ck) else None)
        return out

    with mock.patch.object(cmf, "as_coupled", ingest):
        yield seen


def shared_u_step(check, make_est, X, Y, k, plain, label, exact_loss, steps,
                  bar):
    """step_agreement with K2 (fused_newton_linear_u_pass) launched on both
    sides: each step's V and Z updates start from the same U_new, bit for
    bit (K2 is repeatable, phase 3), so the bars hold K3, K4 and K5 on a
    whole step. Then one step from the estimator's init three ways, all
    kernels, K2 alone, all plain, to show what the plain U step changes:
    U_new's rel Frobenius gap, the rows whose U_new differs by more than
    1e-2 relative (a line-search slot chosen differently; rounding alone
    moves a row by ~1e-4) and V's and Z's gaps. Returns the record."""
    import numpy as np

    from pycmf_tpu_torch.utils.init import initialize_factors

    hybrid = {fn: mod for fn, mod in plain.items()
              if fn != "fused_newton_linear_u_pass"}
    worst = step_agreement(check, make_est, X, Y, k, hybrid,
                           f"{label}, K2's U_new shared", exact_loss, steps,
                           bar)
    est = make_est()
    U, V, Z = initialize_factors(
        X, Y, k, random_state=SEED, U_non_negative=est.U_non_negative,
        V_non_negative=est.V_non_negative, Z_non_negative=est.Z_non_negative)

    def one(patch):
        with ExitStack() as patches:
            for fn, mod in patch.items():
                patches.enter_context(mock.patch.object(
                    mod, fn, getattr(mod, fn + "_ref")))
            return make_est().set_params(
                max_iter=1, eval_every=1, tol=0.0, loop="host"
            ).fit_transform(X, Y, U=U, V=V, Z=Z)
    got, shared, want = one({}), one(hybrid), one(plain)

    def fro(a, b):
        return factor_gap([a], [b])
    row = (np.linalg.norm(got[0] - want[0], axis=1)
           / np.maximum(np.linalg.norm(want[0], axis=1), 1e-30))
    rec = dict(
        loss_gap_shared_u=worst,
        u_new_gap=fro(got[0], want[0]),
        u_rows_over_1e2=int(np.sum(row > 1e-2)), u_rows=int(row.size),
        u_row_gap_median=float(np.median(row)),
        plain_vs_kernel={f: fro(g, w) for f, g, w in zip("VZ", got[1:],
                                                          want[1:])},
        shared_u_vs_kernel={f: fro(g, w) for f, g, w in zip(
            "UVZ", got, shared)})
    check(rec["shared_u_vs_kernel"]["U"] == 0.0,
          f"{label}: K2's U_new is the same bits in the kernel step and the "
          f"step with K2 alone launched")
    log(f"  {label}, one step from init: U_new kernel vs plain rel Frobenius "
        f"{rec['u_new_gap']:.3g}, {rec['u_rows_over_1e2']} of "
        f"{rec['u_rows']} rows over 1e-2 relative (median row "
        f"{rec['u_row_gap_median']:.3g}); V, Z kernel vs all plain "
        f"{rec['plain_vs_kernel']}, vs the plain V and Z steps from the "
        f"kernel's U_new {rec['shared_u_vs_kernel']}")
    return rec


def step_vs_dense(check, make_est, X, Y, k, label, bar):
    """One step of the chunked layout against one step of the dense path on
    the same data (X densified), from the estimator's init: factors within
    ``bar`` relative Frobenius."""
    from pycmf_tpu_torch.utils.init import initialize_factors

    U, V, Z = initialize_factors(X, Y, k, random_state=SEED)

    def one(mode):
        return make_est().set_params(max_iter=1, eval_every=1, tol=0.0,
                                     sparse_mode=mode).fit_transform(
            X, Y, U=U, V=V, Z=Z)
    got, want = one("chunked"), one("dense")
    far = factor_gap(got, want)
    check(far <= bar, f"{label}: one chunked step vs one dense step from the "
          f"same factors, rel Frobenius max {far:.3g} <= {bar:g}")
    return far


# -- fp8 data storage (data_dtype='fp8': e4m3 X, ROADMAP A9) ---------------

E4M3 = "float8_e4m3fn"


def quantized(torch, A):
    """Host matrix A with its values rounded to e4m3 as the port's ingest
    rounds them (through float32), as float64: the data an fp8 fit fits."""
    import numpy as np
    import scipy.sparse as sp

    def q(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(
            torch.float8_e4m3fn).double().numpy()
    if sp.issparse(A):
        A = A.tocsr(copy=True).astype(np.float64)
        A.data = q(A.data)
        return A
    return q(A)


def fp8_pair_equal(torch, got, bf16):
    """Whether every output of an fp8 form equals its bf16 form's bit for
    bit (outputs: a tensor or a tuple of them)."""
    if isinstance(got, torch.Tensor):
        got, bf16 = (got,), (bf16,)
    return all(bool(torch.equal(a, b)) for a, b in zip(got, bf16))


def fp8_u_pass_phase(check, torch, mu_fused, newton_fused):
    """Phase 3, the fp8 forms of K1 and K2: e4m3 X 30000 x 11314 (the
    bf16 inputs of u_pass_phase rounded to e4m3, subnormals among them) at
    k = 20 and k = 40 (the wide route), each against its plain version
    (u_pass_phase's bars: K1's U_new rtol 1e-4, numV and gramU 1e-4 relative
    Frobenius; K2's rows agreeing 0.999, numV 1e-3) and against its own
    bf16 form on X widened to bf16, bit for bit (the fp8 form's stages
    hold the bf16 form's chains in its order: u_pass_common.cuh); outputs
    NaN-filled, two calls bitwise equal; times of the fp8 form, its bf16
    form and the
    plain version, and the bound at 1 byte per element of X. Then the edges
    (fp8_u_pass_edges)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    dev = torch.device("cuda")
    l1, l2, eps, pert = 1e-3, 2e-3, 1e-10, 0.2
    rec = {}
    # one draw of the data at k = 40; k = 20 takes the factors' first 20
    # columns (Xn is then a least-squares problem of rank 40 data)
    X32, U40, V40, Vn40, Xn32 = upass_inputs(torch, rng, N, M, 40, dev)
    X, Xn = X32.to(torch.float8_e4m3fn), Xn32.to(torch.float8_e4m3fn)
    del X32, Xn32
    Xb, Xnb = X.to(torch.bfloat16), Xn.to(torch.bfloat16)
    row_sq = (Xn.float() ** 2).sum(dim=1)
    for k in (K, 40):
        U, V, Vn = (a[:, :k].contiguous() for a in (U40, V40, Vn40))
        VtV, BtB, Hinv = upass_mats(torch, V, Vn, l2, pert)
        nbytes = N * M * 1 + 4 * (3 * N * k + 2 * M * k + 2 * k * k)
        bms, bby = bound(nbytes, 4.0 * N * M * k, BF16_FLOPS)
        tag = f"{E4M3}, k={k}"
        sub = (X.float().abs() < 2 ** -6) & (X.float() != 0)
        log(f"phase 3: X {tag} (subnormal share "
            f"{float(sub.float().mean()):.4f})")
        del sub
        kw = dict(trials=TRIALS, non_negative=True)
        calls = {
            "fused_mu_u_pass": (
                lambda A: mu_fused.fused_mu_u_pass(A, U, V, VtV, l1, l2, eps),
                lambda A: mu_fused.fused_mu_u_pass_ref(A, U, V, VtV, l1, l2,
                                                       eps), X, Xb),
            "fused_newton_linear_u_pass": (
                lambda A: newton_fused.fused_newton_linear_u_pass(
                    A, U, Vn, BtB, Hinv, row_sq, l1, l2, **kw),
                lambda A: newton_fused.fused_newton_linear_u_pass_ref(
                    A, U, Vn, BtB, Hinv, row_sq, l1, l2, **kw), Xn, Xnb)}
        for name, (fn, ref, A, Ab) in calls.items():
            out, again = nan_filled(lambda: fn(A)), fn(A)
            bf = fn(Ab)
            torch.cuda.synchronize()
            want = ref(A)
            torch.cuda.synchronize()
            err = float((out[0] - want[0]).abs().max())
            if name == "fused_mu_u_pass":
                ok = bool(torch.allclose(out[0], want[0], rtol=1e-4,
                                         atol=0.0))
                e1, e2 = rel_fro(out[1], want[1]), rel_fro(out[2], want[2])
                check(ok and e1 <= 1e-4 and e2 <= 1e-4,
                      f"K1[{tag}] U_new rtol 1e-4 {ok} (max abs err "
                      f"{err:.3g}), numV {e1:.3g}, gramU {e2:.3g} <= 1e-4")
            else:
                agree = newton_rows_agree(out[0], want[0])
                e1 = rel_fro(out[1], want[1])
                check(agree >= 0.999 and e1 <= 1e-3,
                      f"K2[{tag}] U_new rows agreeing to rtol 1e-4: "
                      f"{agree:.6f} >= 0.999 (max abs err {err:.3g}), numV "
                      f"rel Frobenius {e1:.3g} <= 1e-3")
            same = fp8_pair_equal(torch, out, again)
            eq = fp8_pair_equal(torch, out, bf)
            check(same and eq, f"{name}[{tag}] outputs NaN-filled, two "
                  f"calls bitwise equal {same}; equal to the bf16 form on "
                  f"X widened to bf16, bit for bit {eq}")
            run = lambda: fn(A)  # noqa: E731
            run_b = lambda: fn(Ab)  # noqa: E731
            ms, dms = time_ms(run), device_ms(run)
            bf_ms, bf_dms = time_ms(run_b), device_ms(run_b)
            pms = time_ms(lambda: ref(A), reps=5)
            log(f"  {name}[{tag}] fp8 form {ms:.4f} ms (device alone "
                f"{dms:.4f}); bf16 form on the same values {bf_ms:.4f} "
                f"({bf_dms:.4f}); plain {pms:.4f} ms; bound {bms:.4f} ms "
                f"({bby}, 1 byte per element of X)")
            rec[(name, "fp8", k)] = dict(
                max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms,
                bound_ms=bms, bound_by=bby, bf16_form_ms=bf_ms,
                bf16_form_device_ms=bf_dms, equal_to_bf16_form=eq)
            del out, again, bf, want
    del X, Xn, Xb, Xnb, U, V, Vn, U40, V40, Vn40, row_sq
    torch.cuda.empty_cache()
    fp8_u_pass_edges(check, torch, mu_fused, newton_fused)
    return rec


def fp8_u_pass_edges(check, torch, mu_fused, newton_fused):
    """The fp8 forms of K1 and K2 at the edges of their tiles and of X's
    byte alignment: n in {1, 17}, m in {1, 15, 17, 4097, 11314} (rows of
    odd m start on any byte), k in {1, 7, 12, 20, 33, 40, 100} (one to four
    n8 tiles, and the wide route), and X at byte
    offsets 1 and 3 of its allocation (n = 17, m = 4097 and 11314). Each:
    outputs and workspace NaN-filled, two calls bitwise equal, equal bit for
    bit to the bf16 form on X widened to bf16, and against the plain
    version with u_pass_edges' bars (U_new rtol 1e-4; numV and gramU 1e-4
    against the plain products of the kernel's own U_new; K2's rows, or
    float64's clause where m < k makes rounding in any order move rows)."""
    import numpy as np

    from pycmf_tpu_torch.ops.matmul import operand_dtype

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 6)
    l1, l2, eps, pert = 1e-3, 2e-3, 1e-10, 0.2
    n_cases = 0

    def at_offset(A, off):
        """A copy of A (fp8) starting `off` bytes into its allocation."""
        buf = torch.empty(A.numel() + 16, dtype=torch.uint8, device=dev)
        out = buf[off:off + A.numel()].view(A.dtype).view(A.shape)
        out.copy_(A)
        return out

    def one(n, m, k, off=0):
        X32, U, V, Vn, Xn32 = upass_inputs(torch, rng, n, m, k, dev)
        Us = U * torch.where(torch.rand_like(U) < 0.5, -1.0, 1.0)
        VtV, BtB, Hinv = upass_mats(torch, V, Vn, l2, pert)
        X = X32.to(torch.float8_e4m3fn)
        Xn = Xn32.to(torch.float8_e4m3fn)
        if off:
            X, Xn = at_offset(X, off), at_offset(Xn, off)
        Xb, Xnb = X.to(torch.bfloat16), Xn.to(torch.bfloat16)
        row_sq = (Xn.float() ** 2).sum(dim=1)
        nv = n - 5 if n > 5 else n
        tag = f"n={n} m={m} k={k} {E4M3}" + (f" at byte {off}" if off else "")

        def mu(A):
            return mu_fused.fused_mu_u_pass(A, U, V, VtV, l1, l2, eps,
                                            n_valid=nv)
        got, again, bf = nan_filled(lambda: mu(X)), mu(X), mu(Xb)
        torch.cuda.synchronize()
        want = mu_fused.fused_mu_u_pass_ref(X, U, V, VtV, l1, l2, eps,
                                            n_valid=nv)
        ok = bool(torch.allclose(got[0], want[0], rtol=1e-4, atol=1e-30))
        e1, e2 = own_products(torch, mu_fused, X, got)
        same, eq = fp8_pair_equal(torch, got, again), \
            fp8_pair_equal(torch, got, bf)
        check(ok and e1 <= 1e-4 and e2 <= 1e-4 and same and eq,
              f"K1[{tag}, n_valid={nv}] U_new rtol 1e-4 {ok}, numV "
              f"{e1:.3g}, gramU {e2:.3g} <= 1e-4, two calls bitwise equal "
              f"{same}, equal to the bf16 form {eq}")
        for trials, nonneg in ((TRIALS, True), (0, False)):
            Uk = U if nonneg else Us
            kw = dict(trials=trials, non_negative=nonneg)

            def nt(A):
                return newton_fused.fused_newton_linear_u_pass(
                    A, Uk, Vn, BtB, Hinv, row_sq, l1, l2, **kw)
            got, again, bf = nan_filled(lambda: nt(Xn)), nt(Xn), nt(Xnb)
            torch.cuda.synchronize()
            want = newton_fused.fused_newton_linear_u_pass_ref(
                Xn, Uk, Vn, BtB, Hinv, row_sq, l1, l2, **kw)
            agree = newton_rows_agree(got[0], want[0])
            extra, rows_ok = "", agree >= 0.999
            if not rows_ok:
                w64 = newton_fused.fused_newton_linear_u_pass_ref(
                    Xn.float().double(), Uk.double(),
                    Vn.to(operand_dtype(Xn.dtype)).double(),
                    BtB.double(), Hinv.double(), row_sq.double(), l1, l2,
                    **kw)[0]
                a_k = newton_rows_agree(got[0], w64)
                a_p = newton_rows_agree(want[0], w64)
                extra = (f"; vs float64: kernel {a_k:.6f} >= plain f32 "
                         f"{a_p:.6f}")
                rows_ok = a_k >= a_p
            e1 = own_products(torch, mu_fused, Xn, got)[0]
            same, eq = fp8_pair_equal(torch, got, again), \
                fp8_pair_equal(torch, got, bf)
            check(rows_ok and e1 <= 1e-3 and same and eq,
                  f"K2[{tag}, trials={trials}, non_negative={nonneg}] rows "
                  f"agreeing {agree:.6f} >= 0.999{extra}, numV {e1:.3g} <= "
                  f"1e-3, two calls bitwise equal {same}, equal to the bf16 "
                  f"form {eq}")
        return 3

    for n in (1, 17):
        for m in (1, 15, 17, 4097, M):
            for k in (1, 7, 12, 20, 33, 40, 100):
                n_cases += one(n, m, k)
    for m in (4097, M):
        for off in (1, 3):
            n_cases += one(17, m, 20, off)
    torch.cuda.empty_cache()
    log(f"  K1/K2 fp8 edges: {n_cases} cases")
    fp8_every_pattern(check, torch, mu_fused, newton_fused)


def nan_equal(torch, got, want) -> bool:
    """Whether two tuples of outputs hold NaN at the same places and equal
    bits everywhere else."""
    return all(bool(torch.equal(a.isnan(), b.isnan())) and bool(torch.equal(
        torch.where(a.isnan(), 0.0, a), torch.where(b.isnan(), 0.0, b)))
        for a, b in zip(got, want))


def fp8_every_pattern(check, torch, mu_fused, newton_fused):
    """K1's and K2's fp8 forms on an X whose entries run through all 254
    finite e4m3 bit patterns (±0, the subnormals, the normals to ±448) in
    every row, at k = 20 and 40: in 4-byte-aligned rows (m = 1016, 11312)
    and rows of odd m (1017, 11313, starting on every byte), 300 rows (row
    segments of one, or three, 64-row blocks); each output equal bit for bit
    to its bf16 form on X widened to bf16, and two calls bitwise equal. Then
    the NaN bytes 0x7F and 0xFF in two rows of the odd-m X: NaN exactly
    where the bf16 form gives NaN, the other outputs equal bit for bit."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 7)
    l1, l2, eps, pert = 1e-3, 2e-3, 1e-10, 0.2
    n = 300
    pats = torch.tensor([b for b in range(256) if b & 0x7F != 0x7F],
                        dtype=torch.uint8, device=dev)

    def calls(X, k, U, V, Vn):
        VtV, BtB, Hinv = upass_mats(torch, V, Vn, l2, pert)
        row_sq = (X.float() ** 2).sum(dim=1)
        return {"K1": lambda A: mu_fused.fused_mu_u_pass(A, U, V, VtV, l1,
                                                         l2, eps),
                "K2": lambda A: newton_fused.fused_newton_linear_u_pass(
                    A, U, Vn, BtB, Hinv, row_sq, l1, l2, trials=TRIALS,
                    non_negative=False)}

    n_cases = 0
    for m in (1016, 1017, 11312, 11313):
        X = pats[torch.arange(n * m, device=dev) % pats.numel()].view(
            n, m).view(torch.float8_e4m3fn)
        Xb = X.to(torch.bfloat16)
        for k in (20, 40):
            _, U, V, Vn, _ = upass_inputs(torch, rng, n, m, k, dev,
                                          signed=True)
            for name, fn in calls(X, k, U, V, Vn).items():
                got, again, bf = nan_filled(lambda: fn(X)), fn(X), fn(Xb)
                same = fp8_pair_equal(torch, got, again)
                eq = fp8_pair_equal(torch, got, bf)
                check(same and eq, f"{name}[every finite e4m3 pattern, "
                      f"n={n} m={m} k={k}] two calls bitwise equal {same}, "
                      f"equal to the bf16 form on X widened {eq}")
                n_cases += 1
    m = 1017
    X = pats[torch.arange(n * m, device=dev) % pats.numel()].view(n, m)
    X[7, 5], X[100, 1000] = 0x7F, 0xFF
    X = X.view(torch.float8_e4m3fn)
    Xb = X.to(torch.bfloat16)
    for k in (20, 40):
        _, U, V, Vn, _ = upass_inputs(torch, rng, n, m, k, dev, signed=True)
        for name, fn in calls(X, k, U, V, Vn).items():
            got, bf = fn(X), fn(Xb)
            shows = bool(bf[1].isnan().any())
            eq = nan_equal(torch, got, bf)
            check(shows and eq, f"{name}[NaN bytes 0x7F, 0xFF in rows 7 and "
                  f"100, n={n} m={m} k={k}] the bf16 form shows NaN in numV "
                  f"{shows}; NaN at the same places and the rest equal bit "
                  f"for bit {eq}")
            n_cases += 1
    log(f"  K1/K2 fp8 every bit pattern: {n_cases} cases")


def fp8_sigmoid_phase(check, torch, sigmoid_newton, batched_solve):
    """Phase 3, the fp8 forms of K3 and K4: e4m3 X at the dense sigmoid-X
    shape (30000 x 11314) and its transpose, uniform [0, 1) values rounded
    to e4m3 (every e4m3 value below 1 occurs, subnormals too), against the
    plain version with sigmoid_phase's bars (G, H 1e-4 relative Frobenius;
    phi 2e-5 of its largest |phi|, rows selecting the same slot >= 0.999)
    and against the bf16 form on X widened to bf16, bit for bit (both widen
    X to f32 elementwise, exactly); times of the fp8 form, its bf16 form and
    the plain version, and the bound at 1 byte per element. Then the edges
    (fp8_sigmoid_edges)."""
    import numpy as np

    rng = np.random.RandomState(SEED + 7)
    dev = torch.device("cuda")
    l1, l2, pert = 0.5, 1.0, 0.2
    clock = sm_clock_hz()
    rec = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    for shape, n, q in (("B", N, M), ("Bt", M, N)):
        Mf = 0.3 * torch.from_numpy(rng.randn(n, K).astype(np.float32)).to(dev)
        Bf = 0.3 * torch.from_numpy(rng.randn(q, K).astype(np.float32)).to(dev)
        X = torch.rand(n, q, device=dev, generator=gen).to(
            torch.float8_e4m3fn)
        Xb = X.to(torch.bfloat16)
        tag = f"{shape}[fp8]"
        G, H = nan_filled(lambda: sigmoid_newton.sigmoid_gh_pass(
            X, Mf, Bf, l1, l2))
        G2, H2 = sigmoid_newton.sigmoid_gh_pass(X, Mf, Bf, l1, l2)
        Gb, Hb = sigmoid_newton.sigmoid_gh_pass(Xb, Mf, Bf, l1, l2)
        torch.cuda.synchronize()
        Gr, Hr = sigmoid_newton.sigmoid_gh_pass_ref(X, Mf, Bf, l1, l2)
        eg, eh = rel_fro(G, Gr), rel_fro(H, Hr)
        same = fp8_pair_equal(torch, (G, H), (G2, H2))
        eq3 = fp8_pair_equal(torch, (G, H), (Gb, Hb))
        check(eg <= 1e-4 and eh <= 1e-4 and same and eq3,
              f"K3{tag} G rel Frobenius {eg:.3g}, H {eh:.3g} <= 1e-4, "
              f"NaN-filled, two calls bitwise equal {same}, equal to the "
              f"bf16 form {eq3}")
        err3 = max(float((G - Gr).abs().max()), float((H - Hr).abs().max()))
        d = batched_solve.batched_spd_solve_ref(
            Hr + (l2 + pert) * torch.eye(K, device=dev), Gr)
        del G, H, G2, H2, Gb, Hb, Hr
        kw = dict(trials=TRIALS, non_negative=True)
        phi = nan_filled(lambda: sigmoid_newton.sigmoid_phi_pass(
            X, Mf, d, Bf, l1, l2, **kw))
        phi2 = sigmoid_newton.sigmoid_phi_pass(X, Mf, d, Bf, l1, l2, **kw)
        phib = sigmoid_newton.sigmoid_phi_pass(Xb, Mf, d, Bf, l1, l2, **kw)
        torch.cuda.synchronize()
        phr = sigmoid_newton.sigmoid_phi_pass_ref(X, Mf, d, Bf, l1, l2, **kw)
        agree = slot_agreement(phi, phr)
        err4 = float((phi - phr).abs().max())
        rel4 = err4 / float(phr.abs().max())
        same = bool(torch.equal(phi, phi2))
        eq4 = bool(torch.equal(phi, phib))
        check(rel4 <= 2e-5 and agree >= 0.999 and same and eq4,
              f"K4{tag} max abs phi err {err4:.3g}, {rel4:.3g} of the "
              f"largest |phi| <= 2e-5, rows selecting the same slot "
              f"{agree:.6f} >= 0.999, NaN-filled, two calls bitwise equal "
              f"{same}, equal to the bf16 form {eq4}")
        b3 = sigmoid_bound(n, q, K, 1, 1, clock, True)
        b4 = sigmoid_bound(n, q, K, TRIALS + 1, 1, clock, False)
        for name, fn, ref, b, err, eq in (
                ("sigmoid_gh_pass",
                 lambda A: sigmoid_newton.sigmoid_gh_pass(A, Mf, Bf, l1, l2),
                 lambda: sigmoid_newton.sigmoid_gh_pass_ref(X, Mf, Bf, l1,
                                                            l2), b3, err3,
                 eq3),
                ("sigmoid_phi_pass",
                 lambda A: sigmoid_newton.sigmoid_phi_pass(A, Mf, d, Bf, l1,
                                                           l2, **kw),
                 lambda: sigmoid_newton.sigmoid_phi_pass_ref(
                     X, Mf, d, Bf, l1, l2, **kw), b4, err4, eq4)):
            ms, dms = time_ms(lambda: fn(X)), device_ms(lambda: fn(X))
            bf_ms, bf_dms = time_ms(lambda: fn(Xb)), device_ms(lambda: fn(Xb))
            pms = time_ms(ref, reps=5)
            log(f"  {name}{tag} fp8 form {ms:.4f} ms (device alone "
                f"{dms:.4f}); bf16 form {bf_ms:.4f} ({bf_dms:.4f}); plain "
                f"{pms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}, 1 byte per "
                f"element of X)")
            rec[(name, tag)] = dict(
                max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms,
                bound_ms=b[0], bound_by=b[1], bf16_form_ms=bf_ms,
                bf16_form_device_ms=bf_dms, equal_to_bf16_form=eq)
        rec[("sigmoid_phi_pass", tag)]["slot_agreement"] = agree
        del X, Xb, Mf, Bf, Gr, d, phi, phi2, phib, phr
        torch.cuda.empty_cache()
    fp8_sigmoid_edges(check, torch, sigmoid_newton)
    return rec


def fp8_sigmoid_edges(check, torch, sigmoid_newton):
    """The fp8 forms of K3 and K4 at the edges: n in {1, 17, 20}, q in {1,
    15, 17, 4097, 11314} (rows of odd q start on any byte), k in {1, 7, 20,
    33, 100}, K4 with trials 0 and TRIALS and non_negative both ways, and X
    at byte offset 1 of its allocation; outputs NaN-filled, two calls
    bitwise equal, equal bit for bit to the bf16 form on X widened to bf16,
    and against the plain version with sigmoid_phase's bars (where the
    bf16 form's edges, sigmoid_edges, hold the slots of tied rows by
    float64, the bit-for-bit equality carries that here)."""
    import numpy as np

    dev = torch.device("cuda")
    rng = np.random.RandomState(SEED + 8)
    l1, l2, pert = 0.5, 1.0, 0.2
    n_cases = 0

    def one(n, q, k, off=0):
        Mf = 0.3 * torch.from_numpy(rng.randn(n, k).astype(np.float32)).to(dev)
        Bf = 0.3 * torch.from_numpy(rng.randn(q, k).astype(np.float32)).to(dev)
        X = torch.from_numpy(rng.rand(n, q).astype(np.float32)).to(dev).to(
            torch.float8_e4m3fn)
        if off:
            buf = torch.empty(n * q + 16, dtype=torch.uint8, device=dev)
            Xo = buf[off:off + n * q].view(X.dtype).view(n, q)
            Xo.copy_(X)
            X = Xo
        Xb = X.to(torch.bfloat16)
        tag = f"n={n} q={q} k={k} {E4M3}" + (f" at byte {off}" if off else "")

        def gh(A):
            return sigmoid_newton.sigmoid_gh_pass(A, Mf, Bf, l1, l2)
        got, again, bf = nan_filled(lambda: gh(X)), gh(X), gh(Xb)
        torch.cuda.synchronize()
        want = sigmoid_newton.sigmoid_gh_pass_ref(X, Mf, Bf, l1, l2)
        eg, eh = rel_fro(got[0], want[0]), rel_fro(got[1], want[1])
        same, eq = fp8_pair_equal(torch, got, again), \
            fp8_pair_equal(torch, got, bf)
        check(eg <= 1e-4 and eh <= 1e-4 and same and eq,
              f"K3[{tag}] G rel Frobenius {eg:.3g}, H {eh:.3g} <= 1e-4, two "
              f"calls bitwise equal {same}, equal to the bf16 form {eq}")
        eye = (l2 + pert) * torch.eye(k, device=dev)
        cases = 1
        for nonneg in (True, False):
            Mk = Mf.abs() if nonneg else Mf
            Gk, Hk = sigmoid_newton.sigmoid_gh_pass_ref(X, Mk, Bf, l1, l2)
            d = torch.linalg.solve(Hk + eye, Gk[..., None])[..., 0]
            for trials in (0, TRIALS):
                kw = dict(trials=trials, non_negative=nonneg)

                def phi(A):
                    return sigmoid_newton.sigmoid_phi_pass(
                        A, Mk, d, Bf, l1, l2, **kw)
                got, again, bf = nan_filled(lambda: phi(X)), phi(X), phi(Xb)
                torch.cuda.synchronize()
                want = sigmoid_newton.sigmoid_phi_pass_ref(
                    X, Mk, d, Bf, l1, l2, **kw)
                rel = float((got - want).abs().max() / want.abs().max())
                agree = slot_agreement(got, want)
                same, eq = bool(torch.equal(got, again)), \
                    bool(torch.equal(got, bf))
                check(rel <= 2e-5 and same and eq,
                      f"K4[{tag}, trials={trials}, non_negative={nonneg}] "
                      f"max abs phi err {rel:.3g} of the largest |phi| <= "
                      f"2e-5 (slots agreeing {agree:.6f}), two calls "
                      f"bitwise equal {same}, equal to the bf16 form {eq}")
                cases += 1
        return cases

    for n in (1, 17, 20):
        for q in (1, 15, 17, 4097, M):
            for k in (1, 7, 20, 33, 100):
                n_cases += one(n, q, k)
    n_cases += one(17, 4097, 20, off=1)
    torch.cuda.empty_cache()
    log(f"  K3/K4 fp8 edges: {n_cases} cases")


def fp8_ingest_phase(check, torch, X, Y):
    """fp8 ingest on the card: the stored e4m3 bytes of the densified 20NG
    surrogate equal the host's conversion (through float32), the norms are
    those of the stored values, Y is stored at bf16, and the peak device
    memory of the ingest (a transient float32 buffer: 1.36 GB at this
    shape); then the refusals, with the reference's ValueErrors."""
    import numpy as np

    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.utils.validation import as_coupled

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    c = as_coupled(X, torch.float8_e4m3fn, torch.device("cuda"))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    host = torch.from_numpy(X.toarray().astype(np.float32)).to(
        torch.float8_e4m3fn)
    same = bool(torch.equal(c.A.view(torch.uint8).cpu(),
                            host.view(torch.uint8)))
    q = host.double()
    a_sq = float((q ** 2).sum())
    check(same and c.A.dtype == torch.float8_e4m3fn
          and abs(float(c.a_sq) - a_sq) <= 1e-6 * a_sq,
          f"fp8 ingest: {tuple(c.A.shape)} e4m3 on the card, bytes equal to "
          f"the host's conversion {same}, ||X||^2 {float(c.a_sq):.9g} of the "
          f"stored values ({a_sq:.9g}); peak {peak:.3f} GB above the "
          f"resident (the float32 buffer)")
    del c, host, q
    torch.cuda.empty_cache()
    refusals = {}
    for mode, match in (("csr", "dense device storage"),
                        ("chunked", "dense device storage")):
        try:
            CMF(n_components=K, data_dtype="fp8", sparse_mode=mode,
                max_iter=2, device="cuda").fit(X, Y)
            raised = "nothing"
        except ValueError as e:
            raised = str(e)
        refusals[mode] = raised
        check(match in raised, f"fp8 with sparse_mode={mode!r} on the card "
              f"raises ValueError: {raised[:100]}...")
    return dict(ingest_peak_gb=peak, bytes_equal=same, refusals=refusals)


def fp8_matches_bf16(check, make8, makeb, X, Xq, Y, label):
    """An fp8 fit on the card against the bf16 fit of X quantized to e4m3,
    from the same initial factors: equal bit for bit (losses, factors,
    n_iter_; every fp8 form equals its bf16 form, phase 3, and the rest of
    the path is the same), and then the fold-in of 1000 new rows from the
    same U. Returns (the two estimators, the record)."""
    import numpy as np

    from pycmf_tpu_torch.utils.init import initialize_factors

    est = make8()
    U, V, Z = initialize_factors(
        X, Y, K, random_state=SEED, U_non_negative=est.U_non_negative,
        V_non_negative=est.V_non_negative, Z_non_negative=est.Z_non_negative)
    a = make8().fit(X, Y, U=U, V=V, Z=Z)
    b = makeb().fit(Xq, Y, U=U, V=V, Z=Z)
    bits = a.n_iter_ == b.n_iter_ and a.loss_history_ == b.loss_history_ \
        and all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("U_", "V_", "Z_"))
    gap = factor_gap([a.U_, a.V_, a.Z_], [b.U_, b.V_, b.Z_])
    Ut8 = a.transform(X[:1000], U=U[:1000])
    Utb = b.transform(Xq[:1000], U=U[:1000])
    tbits = bool(np.array_equal(Ut8, Utb))
    check(bits and tbits and bool(np.all(np.isfinite(Ut8)))
          and Ut8.shape == (1000, K),
          f"{label}: fp8 fit vs the bf16 fit of the quantized X from the "
          f"same factors, {a.n_iter_} iterations: bit for bit {bits} "
          f"(factors rel Frobenius {gap:.3g}); transform of 1000 rows "
          f"{Ut8.shape}, finite, bit for bit {tbits}")
    return a, b, dict(n_iter=a.n_iter_, bit_equal=bits, factor_gap=gap,
                      transform_bit_equal=tbits)


R2_TIMEOUT = 360.0  # seconds for phase R2's two ranks, start to end


R1_ROUNDS = 2  # phase R1's timed rounds: the four variants in turn


def nccl_world1_phase(check, torch, X, Y, common, paths):
    """Phase R1: run_sharded on a one-rank NCCL group in this process (the
    estimator's n_shards=1 is the single-device fit), each path against the
    single-device host-loop fit of the same inputs: n_iter, the loss
    history and the factors, bit for bit expected. Its time beside three
    variants, in turns over R1_ROUNDS rounds (the host loop of a
    launch-bound path spreads from fit to fit): the single-device fit, a
    one-rank gloo group on the same CUDA tensors, and the NCCL fit with the
    collective replaced by nothing (at one rank it changes no value: what
    the sharded path costs without its collective). Then one more NCCL fit
    with CUDA events around every all-reduce. Returns (record, launches of
    the sharded fits)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.parallel.mesh import COMM
    from pycmf_tpu_torch.parallel.sharded import run_sharded
    from pycmf_tpu_torch.solvers.common import make_hyper
    from pycmf_tpu_torch.utils.init import initialize_factors

    rec, launches = {}, {}
    store = os.path.join(tempfile.mkdtemp(prefix="pycmf_r1_"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        gloo = dist.new_group(backend="gloo")
        for label, kw, minimums in paths:
            est = CMF(**kw, **common, loop="host")
            cfg = est._config(has_Y=True)
            hyper = make_hyper(est.alpha, est.l1_ratio, est.eps,
                               est.hessian_pertubation, dtype=torch.float32)
            U0, V0, Z0 = initialize_factors(
                X, Y, K, random_state=SEED,
                U_non_negative=est.U_non_negative,
                V_non_negative=est.V_non_negative,
                Z_non_negative=est.Z_non_negative)

            def sharded(max_iter=est.max_iter, timed=False, group=None):
                COMM.reset(timed)
                out = run_sharded(
                    est.solver, X, Y, U0, V0, Z0, cfg, hyper, n_shards=1,
                    group=group, dtype=torch.float32,
                    data_dtype=torch.bfloat16, device=common["device"],
                    max_iter=max_iter, tol=est.tol,
                    eval_every=est.eval_every,
                    sparse_mode=est._matrix_sparse_mode(X, est.x_link))
                torch.cuda.synchronize()
                return out

            def ms_iter(out):
                return 1e3 * sum(out[6]) / out[3]

            def single():
                e = CMF(**kw, **common, loop="host").fit(X, Y)
                return 1e3 * sum(e.step_times_) / e.n_iter_

            def without_collective():
                with mock.patch.object(dist, "all_reduce",
                                       lambda *a, **k: None):
                    return ms_iter(sharded())
            # warm-ups, not timed
            sharded(max_iter=2)
            sharded(max_iter=2, group=gloo)
            CMF(**dict(kw, max_iter=2, eval_every=1, tol=0.0), **common,
                loop="host").fit(X, Y)
            reset_launch_counts()
            U, V, Z, n_iter, losses, iters, times = sharded()
            counts = launch_counts()
            calls, nbytes = COMM.calls, COMM.nbytes
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            one = CMF(**kw, **common, loop="host").fit(X, Y)
            variants = {
                "single_device": single,
                "nccl": lambda: ms_iter(sharded()),
                "gloo": lambda: ms_iter(sharded(group=gloo)),
                "no_collective": without_collective}
            ms = {v: [] for v in variants}
            host = {"nccl": [], "gloo": []}
            for _ in range(R1_ROUNDS):
                for v, fn in variants.items():
                    ms[v].append(fn())
                    if v in host:
                        host[v].append(1e3 * COMM.host_s / COMM.calls)
            # with CUDA events around every all-reduce; the first two (the
            # set-up's norms, the initial loss) and the last (the gather of
            # U) lie outside the blocks
            t_out = sharded(timed=True)
            comm_ms = sum(a.elapsed_time(b) for a, b in COMM.events[2:-1])
            fit_ms = 1e3 * sum(t_out[6])
            m, k = X.shape[1], K
            r = dict(
                n_iter=n_iter, single_n_iter=one.n_iter_,
                losses=[float(v) for v in losses],
                single_losses=one.loss_history_,
                losses_bit_equal=[float(v) for v in losses]
                == one.loss_history_,
                loss_max_rel=float(np.max(
                    np.abs(np.subtract(losses, one.loss_history_))
                    / np.abs(one.loss_history_))),
                factor_gap=factor_gap(
                    [U.double().cpu().numpy(), V.double().cpu().numpy()],
                    [one.U_, one.V_]),
                ms_per_iter={v: sorted(t) for v, t in ms.items()},
                least_ms_per_iter={v: min(t) for v, t in ms.items()},
                median_ms_per_iter={v: float(np.median(t))
                                    for v, t in ms.items()},
                allreduce_host_ms_per_call={v: min(t)
                                            for v, t in host.items()},
                timed_ms_per_iter=fit_ms / t_out[3],
                allreduce_ms_per_iter=comm_ms / t_out[3],
                allreduce_share=comm_ms / fit_ms,
                allreduce_calls=calls,
                allreduce_bytes=nbytes,
                allreduce_bytes_per_iter_code=(m * k + k * k) * 4,
                launches=counts)
            check(n_iter == one.n_iter_ and r["loss_max_rel"] <= 1e-6,
                  f"R1 {label}: n_iter {n_iter} (single {one.n_iter_}); "
                  f"loss history within 1e-6 of the single-device fit's "
                  f"(max rel {r['loss_max_rel']:.3g}, bit for bit: "
                  f"{r['losses_bit_equal']}); factors gap "
                  f"{r['factor_gap']:.3g}")
            for name, per in minimums.items():
                got = counts.get(name, 0)
                check(got >= per * n_iter,
                      f"R1 {label}: {name} launches {got} >= {per} x "
                      f"{n_iter}")
            least, med = r["least_ms_per_iter"], r["median_ms_per_iter"]
            log(f"  R1 {label}: ms/iter least (median) of {R1_ROUNDS}: "
                + ", ".join(f"{v} {least[v]:.4f} ({med[v]:.4f})"
                            for v in variants)
                + f"; host ms per all-reduce call "
                f"{r['allreduce_host_ms_per_call']}; with events "
                f"{r['timed_ms_per_iter']:.4f} ms/iter of which all-reduce "
                f"{r['allreduce_ms_per_iter']:.4f} "
                f"({r['allreduce_share']:.3%}); {calls} all-reduces, "
                f"{nbytes} bytes in the fit, "
                f"{r['allreduce_bytes_per_iter_code']} per iteration by the "
                f"code; launches {counts}")
            rec[label] = r
    finally:
        dist.destroy_process_group()
    return rec, launches


R1C_ROUNDS = 2  # phases R1c and R1g: the layout and single device in turn
# R2 S (path S in two gloo ranks, each drawing other columns than the
# single device, so only the draws' statistics are shared): its exact loss
# must lie within the range of path S's single-device exact losses from the
# same initial factors over R2S_SEEDS keys, widened by R2S_BAR on each side
R2S_BAR = 5e-2
R2S_SEEDS = 6
# R1 S's eval losses (full losses of bit-equal factors: the sharded one at
# the factors' precision, the single device's on the bf16 product)
R1S_LOSS_BAR = 1e-4


def nccl_world1_layout_phase(check, torch, Y, common, paths, layout, tag,
                             bar):
    """Phases R1c and R1g: run_sharded(layout='cols') or
    run_grid(grid=(1, 1)) on a one-rank NCCL group in this process (the
    grid's two axis subgroups made under NCCL too; on a (1, 1) mesh they
    make no collective, the world group's calls remain), each path run to
    the single-device host-loop fit's n_iter (tol 0) and held to it by the
    exact float64 loss of the final factors (``bar`` relative): neither is the
    single device's arithmetic (X V is a plain product summed over the
    ranks, K1 and K2 never run). Times in turns over R1C_ROUNDS rounds
    beside the single-device fit, then one fit with CUDA events around
    every all-reduce (calls, bytes and device ms per mesh axis). paths:
    (label, kw, X, exact loss of (U, V, Z), {kernel: launches per
    iteration}, ref); with ``ref`` (the path's phase-7 record: n_iter,
    exact_loss, and ms_per_iter of its host-loop fit) no single-device fit
    is run and the layout's ms/iter is the least of its counted and timed
    fits (a path whose ingest takes seconds). Returns (record, launches of the layout's
    fits)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.parallel.grid import run_grid
    from pycmf_tpu_torch.parallel.mesh import COMM
    from pycmf_tpu_torch.parallel.sharded import run_sharded
    from pycmf_tpu_torch.solvers.common import make_hyper
    from pycmf_tpu_torch.utils.init import initialize_factors

    rec, launches = {}, {}
    store = os.path.join(tempfile.mkdtemp(prefix=f"pycmf_{tag}_"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    # the set-up's event and the initial loss's lie outside the blocks, and
    # for cols the last (the gather of V); on the (1, 1) grid the gathers
    # of U and V run on one-rank axes, which make no call
    tail = 1 if layout == "cols" else 0
    try:
        for label, kw, X, exact_loss, minimums, ref in paths:
            est = CMF(**kw, **common, loop="host")
            cfg = est._config(has_Y=True)
            hyper = make_hyper(est.alpha, est.l1_ratio, est.eps,
                               est.hessian_pertubation, dtype=torch.float32)
            U0, V0, Z0 = initialize_factors(
                X, Y, K, random_state=SEED,
                U_non_negative=est.U_non_negative,
                V_non_negative=est.V_non_negative,
                Z_non_negative=est.Z_non_negative)
            rounds = ref is None   # else ms/iter from the phase-7 fit
            if rounds:
                one = CMF(**kw, **common, loop="host").fit(X, Y)
                ref = dict(n_iter=one.n_iter_,
                           exact_loss=exact_loss(one.U_, one.V_, one.Z_))
            # a path whose upload takes seconds (F's BlockEll cell, K's
            # chunked one) uploads once for its two fits
            setup = None if rounds else shard_setup_once()

            def fit(max_iter=ref["n_iter"], timed=False):
                COMM.reset(timed)
                args = (est.solver, X, Y, U0, V0, Z0, cfg, hyper)
                kws = dict(dtype=torch.float32, data_dtype=torch.bfloat16,
                           device=common["device"], max_iter=max_iter,
                           tol=0.0, eval_every=est.eval_every,
                           sparse_mode=est._matrix_sparse_mode(X, est.x_link))
                out = (run_sharded(*args, n_shards=1, layout="cols", **kws)
                       if layout == "cols" else
                       run_grid(*args, grid=(1, 1), **kws))
                torch.cuda.synchronize()
                return out

            def single():
                e = CMF(**kw, **common, loop="host").fit(X, Y)
                return 1e3 * sum(e.step_times_) / e.n_iter_

            if rounds:
                fit(max_iter=2)  # warm-up, not timed
            reset_launch_counts()
            U, V, Z, n_iter, losses, iters, times = out = fit()
            counts = launch_counts()
            calls, nbytes = COMM.calls, COMM.nbytes
            by_axis = {a: list(v) for a, v in COMM.by_axis.items()}
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            ms = {"single_device": [], layout: [1e3 * sum(out[6]) / out[3]]}
            if not rounds:
                ms["single_device"].append(ref["ms_per_iter"])
            else:
                ms[layout] = []
                for _ in range(R1C_ROUNDS):
                    ms["single_device"].append(single())
                    o = fit()
                    ms[layout].append(1e3 * sum(o[6]) / o[3])
            t_out = fit(timed=True)
            if setup is not None:
                setup.close()
            # the set-up's all-reduce (none when uploaded once) and L0's
            # precede the blocks
            head = 2 if setup is None else 1
            blocks = list(zip(COMM.events, COMM.event_axes))[
                head:len(COMM.events) - tail]
            comm_ms = sum(a.elapsed_time(b) for (a, b), _ in blocks)
            axis_ms = {}
            for (a, b), ax in blocks:
                axis_ms[ax] = axis_ms.get(ax, 0.0) + a.elapsed_time(b)
            fit_ms = 1e3 * sum(t_out[6])
            if not rounds:
                ms[layout].append(fit_ms / t_out[3])
            exact = exact_loss(*(t.double().cpu().numpy()
                                 for t in (U, V, Z)))
            want = ref["exact_loss"]
            gap = abs(exact - want) / want
            n = X.shape[0]
            r = dict(
                n_iter=n_iter, single_n_iter=ref["n_iter"], exact_loss=exact,
                single_exact_loss=want, rel_gap=gap,
                losses=[float(v) for v in losses],
                ms_per_iter={v: sorted(t) for v, t in ms.items()},
                least_ms_per_iter={v: min(t) for v, t in ms.items()},
                timed_ms_per_iter=fit_ms / t_out[3],
                allreduce_ms_per_iter=comm_ms / t_out[3],
                allreduce_share=comm_ms / fit_ms,
                allreduce_calls=calls, allreduce_bytes=nbytes,
                allreduce_by_axis=by_axis,
                allreduce_ms_per_iter_by_axis={
                    a: v / t_out[3] for a, v in axis_ms.items()},
                allreduce_bytes_per_iter_code=(
                    (n * K + K * K + Y.shape[1] * K) * 4
                    if est.solver == "mu" and layout == "cols" else None),
                launches=counts)
            check(n_iter == ref["n_iter"] and gap < bar,
                  f"{tag} {label}: {n_iter} iterations (single device "
                  f"{ref['n_iter']}); exact f64 loss {exact:.9g} vs the "
                  f"single-device fit's {want:.9g}: rel gap {gap:.3g} < "
                  f"{bar:g}")
            for name, per in minimums.items():
                got = counts.get(name, 0)
                check(got >= per * n_iter,
                      f"{tag} {label}: {name} launches {got} >= {per} x "
                      f"{n_iter}")
            least = r["least_ms_per_iter"]
            log(f"  {tag} {label}: ms/iter least of "
                f"{len(ms[layout])}: {layout} {least[layout]:.4f}, single "
                f"device {least['single_device']:.4f}; with events "
                f"{r['timed_ms_per_iter']:.4f} ms/iter of which all-reduce "
                f"{r['allreduce_ms_per_iter']:.4f} "
                f"({r['allreduce_share']:.3%}); by axis (calls, bytes in "
                f"the fit) {by_axis}, device ms/iter "
                f"{r['allreduce_ms_per_iter_by_axis']}; {calls} all-reduces,"
                f" {nbytes} bytes; launches {counts}")
            rec[label] = r
    finally:
        dist.destroy_process_group()
    return rec, launches


def nccl_world1_fp8_phase(check, torch, X, Y, common8, paths):
    """Phase R1 fp8: run_sharded (rows) on a one-rank NCCL group with e4m3
    X, each path against the single-device fp8 host-loop fit of the same
    inputs, run to its n_iter (tol 0): every eval loss and the factors bit
    for bit, K1's or K2's e4m3 form launched every iteration and the bf16
    form never. paths: (label, kw, {kernel:
    launches per iteration}, kernels absent). Returns (record, launches)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.parallel.sharded import run_sharded
    from pycmf_tpu_torch.solvers.common import make_hyper
    from pycmf_tpu_torch.utils.init import initialize_factors

    rec, launches = {}, {}
    store = os.path.join(tempfile.mkdtemp(prefix="pycmf_r1f_"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        for label, kw, minimums, absent in paths:
            est = CMF(**kw, **common8, loop="host")
            one = CMF(**kw, **common8, loop="host").fit(X, Y)
            cfg = est._config(has_Y=True)
            hyper = make_hyper(est.alpha, est.l1_ratio, est.eps,
                               est.hessian_pertubation, dtype=torch.float32)
            U0, V0, Z0 = initialize_factors(
                X, Y, K, random_state=SEED,
                U_non_negative=est.U_non_negative,
                V_non_negative=est.V_non_negative,
                Z_non_negative=est.Z_non_negative)
            reset_launch_counts()
            t0 = time.perf_counter()
            U, V, Z, n_iter, losses, iters, times = run_sharded(
                est.solver, X, Y, U0, V0, Z0, cfg, hyper, n_shards=1,
                dtype=torch.float32, data_dtype=torch.float8_e4m3fn,
                device=common8["device"], max_iter=one.n_iter_, tol=0.0,
                eval_every=est.eval_every,
                sparse_mode=est._matrix_sparse_mode(X, est.x_link))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            got = [U.double().cpu().numpy(), V.double().cpu().numpy(),
                   Z.double().cpu().numpy()]
            bits = ([float(v) for v in losses] == one.loss_history_
                    and all(np.array_equal(a, b) for a, b in zip(
                        got, (one.U_, one.V_, one.Z_))))
            ms = 1e3 * sum(times) / n_iter
            r = dict(n_iter=n_iter, single_n_iter=one.n_iter_,
                     bit_equal=bits,
                     factor_gap=factor_gap(got, [one.U_, one.V_, one.Z_]),
                     ms_per_iter=ms,
                     single_ms_per_iter=1e3 * sum(one.step_times_)
                     / one.n_iter_, wall_s=wall, launches=counts)
            check(n_iter == one.n_iter_ and bits,
                  f"R1 fp8 {label}: {n_iter} iterations (single device "
                  f"{one.n_iter_}); eval losses and factors bit for bit: "
                  f"{bits} (factors gap {r['factor_gap']:.3g})")
            for name, per in minimums.items():
                check(counts.get(name, 0) >= per * n_iter,
                      f"R1 fp8 {label}: {name} launches "
                      f"{counts.get(name, 0)} >= {per} x {n_iter}")
            check(all(counts.get(a, 0) == 0 for a in absent),
                  f"R1 fp8 {label}: the bf16 forms {absent} launched no "
                  f"time")
            log(f"  R1 fp8 {label}: {ms:.4f} ms/iter (single device "
                f"{r['single_ms_per_iter']:.4f}), fit wall {wall:.2f} s incl."
                f" the host's densify and e4m3 conversion; launches {counts}")
            rec[label] = r
    finally:
        dist.destroy_process_group()
    return rec, launches


def nccl_world1_bits_phase(check, torch, X, Y, common, paths):
    """Phases R1 S, R1 K and R1 KA: run_sharded (rows) on a one-rank NCCL
    group, each path against the single-device host-loop fit of the same
    inputs: n_iter and the factors bit for bit, and every eval loss (L0
    included) bit for bit, or within ``loss_bar`` where the two take
    different formulas: a sampled path's eval losses are full losses, and
    the sharded one takes ⟨X, UVᵀ⟩ at the factors' precision where the
    single device takes the bf16 product (the reference's two formulas).
    The sampled path (S) records the sharded fit's draws by wrapping the
    solver's draw (solvers/newton.choice_without_replacement, under
    draw_columns and sample_mask) and replays them, in the order they were
    made, into the single-device fit (one order on both: U's term, Z's,
    V's X and Y terms; a one-rank rows fit folds its keys with rank 0, as
    the reference's does, so it draws other columns than the single
    device); on a chunked path the U pass's kernel launches as often as on
    the single device (its chunks per iteration). Then one more sharded fit
    with CUDA events around every all-reduce (its share). paths: (label,
    kw, {kernel: launches per iteration}, kernels launched as often as on
    the single device, kernels absent, loss_bar: 0 for bit for bit).
    Returns (record, launches of the counted sharded fits)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.parallel.mesh import COMM
    from pycmf_tpu_torch.parallel.sharded import run_sharded
    from pycmf_tpu_torch.solvers import newton as tnewton
    from pycmf_tpu_torch.solvers.common import make_hyper
    from pycmf_tpu_torch.utils.init import initialize_factors

    rec, launches = {}, {}
    store = os.path.join(tempfile.mkdtemp(prefix="pycmf_r1b_"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    real_draw = tnewton.choice_without_replacement
    try:
        for label, kw, minimums, same, absent, loss_bar in paths:
            est = CMF(**kw, **common, loop="host")
            cfg = est._config(has_Y=True)
            hyper = make_hyper(est.alpha, est.l1_ratio, est.eps,
                               est.hessian_pertubation, dtype=torch.float32)
            U0, V0, Z0 = initialize_factors(
                X, Y, K, random_state=SEED,
                U_non_negative=est.U_non_negative,
                V_non_negative=est.V_non_negative,
                Z_non_negative=est.Z_non_negative)

            def sharded(timed=False):
                COMM.reset(timed)
                out = run_sharded(
                    est.solver, X, Y, U0, V0, Z0, cfg, hyper, n_shards=1,
                    dtype=torch.float32, data_dtype=torch.bfloat16,
                    device=common["device"], max_iter=est.max_iter,
                    tol=est.tol, eval_every=est.eval_every,
                    sparse_mode=est._matrix_sparse_mode(X, est.x_link),
                    seed=SEED)
                torch.cuda.synchronize()
                return out
            drawn = []

            def recorded(key, q, s):
                drawn.append((q, real_draw(key, q, s)))
                return drawn[-1][1]
            reset_launch_counts()
            with mock.patch.object(tnewton, "choice_without_replacement",
                                   recorded):
                U, V, Z, n_iter, losses, iters, times = sharded()
            counts = launch_counts()
            calls, nbytes = COMM.calls, COMM.nbytes
            for name, n in counts.items():
                launches[name] = launches.get(name, 0) + n
            replay, misfits = iter(drawn), []

            def replayed(key, q, s):
                want_q, idx = next(replay)
                if (want_q, idx.numel()) != (q, s):
                    misfits.append((q, s, want_q, idx.numel()))
                return idx
            reset_launch_counts()
            with mock.patch.object(tnewton, "choice_without_replacement",
                                   replayed):
                one = CMF(**kw, **common, loop="host").fit(X, Y)
            single = launch_counts()
            t_out = sharded(timed=True)
            comm_ms = sum(a.elapsed_time(b) for a, b in COMM.events[2:-1])
            fit_ms = 1e3 * sum(t_out[6])
            got = [t.double().cpu().numpy() for t in (U, V, Z)]
            loss_bits = [float(v) for v in losses] == one.loss_history_
            factor_bits = all(np.array_equal(a, b) for a, b in zip(
                got, (one.U_, one.V_, one.Z_)))
            r = dict(
                n_iter=n_iter, single_n_iter=one.n_iter_,
                draws=len(drawn), losses=[float(v) for v in losses],
                single_losses=one.loss_history_,
                losses_bit_equal=loss_bits, factors_bit_equal=factor_bits,
                loss_max_rel=float(np.max(
                    np.abs(np.subtract(losses, one.loss_history_))
                    / np.abs(one.loss_history_))),
                factor_gap=factor_gap(got, [one.U_, one.V_, one.Z_]),
                ms_per_iter=1e3 * sum(times) / n_iter,
                single_ms_per_iter=1e3 * sum(one.step_times_) / one.n_iter_,
                timed_ms_per_iter=fit_ms / t_out[3],
                allreduce_ms_per_iter=comm_ms / t_out[3],
                allreduce_share=comm_ms / fit_ms, allreduce_calls=calls,
                allreduce_bytes=nbytes, launches=counts,
                single_launches=single)
            losses_ok = loss_bits or r["loss_max_rel"] < loss_bar
            check(n_iter == one.n_iter_ and losses_ok and factor_bits
                  and not misfits,
                  f"R1 {label}: {n_iter} iterations (single {one.n_iter_}); "
                  f"factors bit for bit: {factor_bits} (gap "
                  f"{r['factor_gap']:.3g}); every eval loss bit for bit: "
                  f"{loss_bits}" + (f", else within {loss_bar:g} (max rel "
                                    f"{r['loss_max_rel']:.3g})"
                                    if loss_bar else "")
                  + f"; {len(drawn)} draws replayed, each of the recorded "
                  f"size: {not misfits}")
            for name, per in minimums.items():
                check(counts.get(name, 0) >= per * n_iter,
                      f"R1 {label}: {name} launches {counts.get(name, 0)} "
                      f">= {per} x {n_iter}")
            for name in same:
                check(counts.get(name, 0) == single.get(name, 0)
                      == minimums[name] * n_iter,
                      f"R1 {label}: {name} launches {counts.get(name, 0)}, "
                      f"the single device's {single.get(name, 0)}: "
                      f"{minimums[name]} per iteration (its chunks)")
            check(all(counts.get(a, 0) == 0 for a in absent),
                  f"R1 {label}: {absent} launched no time")
            log(f"  R1 {label}: {r['ms_per_iter']:.4f} ms/iter (single "
                f"device {r['single_ms_per_iter']:.4f}); with events "
                f"{r['timed_ms_per_iter']:.4f} ms/iter of which all-reduce "
                f"{r['allreduce_ms_per_iter']:.4f} "
                f"({r['allreduce_share']:.3%}); {calls} all-reduces, "
                f"{nbytes} bytes; launches {counts}")
            rec[label] = r
    finally:
        dist.destroy_process_group()
    return rec, launches


def launch_profile(torch, fn) -> dict:
    """fn() under torch.profiler: the host's launch calls (LAUNCH_APIS),
    its graph launches (cudaGraphLaunch, one per replay or fit graph), the
    device's busy ms (kernels, copies and memsets) and the wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    calls = graphs = 0
    busy = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.time_range.elapsed_us() / 1e3
        elif e.name in LAUNCH_APIS:
            calls += 1
            graphs += e.name == "cudaGraphLaunch"
    return dict(out=out, launch_calls=calls, graph_launches=graphs,
                device_ms=busy, wall_ms=wall)


def shard_setup_once():
    """A patch of the sharded layouts' set-up (``prepare_rows``,
    ``prepare_cols``, ``prepare_grid``) that uploads each call's operands
    once and hands them to every later call with the same arguments (the
    fits read them and never write them; each gets its own copy of the
    initial factors). Phase R1d runs each path a dozen times; the upload
    is outside ms/iter and its collectives precede the fit (so only the
    first call counts them in COMM). Active from the call; close() the
    returned ExitStack to end it."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from pycmf_tpu_torch.parallel import grid as tgrid
    from pycmf_tpu_torch.parallel import sharded as tsharded

    memo = {}

    def once(fn):
        def setup(*args):
            key = (fn.__name__,) + tuple(
                id(a) if isinstance(a, (np.ndarray, sp.spmatrix)) else a
                for a in args)
            if key not in memo:
                memo[key] = (args, fn(*args))  # args kept: their ids
            return tuple(t.clone() if isinstance(t, torch.Tensor) else t
                         for t in memo[key][1])
        return setup

    stack = ExitStack()
    for mod, name in ((tsharded, "prepare_rows"), (tsharded, "prepare_cols"),
                      (tgrid, "prepare_grid")):
        stack.enter_context(mock.patch.object(mod, name,
                                              once(getattr(mod, name))))
    return stack


def nccl_world1_device_loop_phase(check, torch, X, Y, common, paths):
    """Phase R1d: the device loop under shards (loop='device' of
    run_sharded and run_grid) on a one-rank NCCL group in this process,
    each path's collectives captured into the fit's CUDA graphs. Per path,
    from an emptied fit cache: two host-loop fits of the same sharded
    call, then the key's first device fit (an eager block, a graph of one
    eval block replayed per block), its second (builds the cache entry)
    and two hits (one launch of the fit graph, a sampled path's too; a
    replay per block only when the captured block holds a node type a
    conditional body refuses, which LAST_FIT names). Each device fit is held bit for
    bit against the host fit (n_iter, the loss history, U, V, Z) with equal
    COMM calls and bytes; the hit's kernel launches equal the host fit's
    but fit_loop's. Then a hit and a host fit under torch.profiler (host
    launch calls, graph launches, device ms per fit), and the first fit,
    second fit and two hits again with dist.all_reduce patched to nothing
    (at one rank it changes no value; the captures record no collective):
    the hit's ms/iter without its collective. Host loop and hits: least of
    2. paths: (label, kw, layout, {kernel: launches per iteration}).
    Returns (record, launches of the first hit)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.parallel.grid import run_grid
    from pycmf_tpu_torch.parallel.mesh import COMM
    from pycmf_tpu_torch.parallel.sharded import run_sharded
    from pycmf_tpu_torch.solvers.common import (LAST_FIT, clear_fit_cache,
                                                fit_cache_entries, make_hyper)
    from pycmf_tpu_torch.utils.init import initialize_factors

    rec, launches = {}, {}
    store = os.path.join(tempfile.mkdtemp(prefix="pycmf_r1d_"), "store")
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    setup = shard_setup_once()
    try:
        for label, kw, layout, minimums in paths:
            est = CMF(**kw, **common, loop="host")
            cfg = est._config(has_Y=True)
            hyper = make_hyper(est.alpha, est.l1_ratio, est.eps,
                               est.hessian_pertubation, dtype=torch.float32)
            U0, V0, Z0 = initialize_factors(
                X, Y, K, random_state=SEED,
                U_non_negative=est.U_non_negative,
                V_non_negative=est.V_non_negative,
                Z_non_negative=est.Z_non_negative)
            def fit(loop):
                COMM.reset()
                LAST_FIT.clear()
                reset_launch_counts()
                args = (est.solver, X, Y, U0, V0, Z0, cfg, hyper)
                kws = dict(dtype=torch.float32, data_dtype=torch.bfloat16,
                           device=common["device"], max_iter=est.max_iter,
                           tol=est.tol, eval_every=est.eval_every,
                           loop=loop, seed=SEED,
                           sparse_mode=est._matrix_sparse_mode(X, est.x_link))
                out = (run_grid(*args, grid=(1, 1), **kws)
                       if layout == "grid" else
                       run_sharded(*args, n_shards=1, layout=layout, **kws))
                torch.cuda.synchronize()
                U, V, Z, n_iter, losses, iters, times = out
                return dict(
                    n_iter=n_iter, losses=[float(v) for v in losses],
                    factors=[t.cpu() for t in (U, V, Z)],
                    ms_per_iter=1e3 * sum(times) / n_iter,
                    comm=(COMM.calls, COMM.nbytes), counts=launch_counts(),
                    info=dict(LAST_FIT))

            def same(a, b):
                return (a["n_iter"] == b["n_iter"]
                        and a["losses"] == b["losses"]
                        and all(torch.equal(x, y) for x, y in
                                zip(a["factors"], b["factors"])))

            clear_fit_cache()
            host, host2 = fit("host"), fit("host")
            first, build, hit, hit2 = (fit("device") for _ in range(4))
            (entry,) = fit_cache_entries()
            nodes = entry.nodes
            prof = launch_profile(torch, lambda: fit("device"))
            pfit, hprof = prof.pop("out"), launch_profile(
                torch, lambda: fit("host"))
            hprof.pop("out")
            with mock.patch.object(dist, "all_reduce",
                                   lambda *a, **k: None):
                clear_fit_cache()
                bare = [fit("device") for _ in range(4)]
            clear_fit_cache()

            def least(*fits):
                return min(f["ms_per_iter"] for f in fits)
            full = host["n_iter"] // min(est.eval_every, est.max_iter)
            blocks = len(host["losses"]) - 1
            refused = hit["info"].get("refused")
            per_block = refused is not None
            want = (0, full) if per_block else (1, 0)
            for name, f in (("first", first), ("second", build),
                            ("hit", hit), ("second hit", hit2),
                            ("profiled hit", pfit),
                            ("hit without collective", bare[3])):
                check(same(f, host) and f["comm"] == host2["comm"],
                      f"R1d {label}: the {name} device fit equals the host "
                      f"loop's bit for bit (n_iter {f['n_iter']}, "
                      f"{len(f['losses'])} losses, U, V, Z), COMM calls and "
                      f"bytes {f['comm']} == {host2['comm']} (the host "
                      f"loop's on the same uploaded operands)")
            fi, bi, hi = first["info"], build["info"], hit["info"]
            check(not fi["hit"] and fi["eager_blocks"] == 1
                  and fi["captures"] == int(full > 1)
                  and not bi["hit"] and bi["captures"] >= 1
                  and (bi["graph_launches"], bi["replays"]) == want
                  and hi["hit"] and hi["captures"] == 0
                  and hi["eager_blocks"] == 0
                  and (hi["graph_launches"], hi["replays"]) == want,
                  f"R1d {label}: first fit {fi}, second {bi}, hit {hi} "
                  f"(per block: {per_block}, refused node: {refused})")
            hc, dc = ({k: v for k, v in c.items() if k != "fit_loop"}
                      for c in (host["counts"], hit["counts"]))
            check(hc == dc, f"R1d {label}: the hit's launches {dc} equal the "
                  f"host loop's")
            for name, per in minimums.items():
                check(dc.get(name, 0) >= per * hit["n_iter"],
                      f"R1d {label}: {name} launches {dc.get(name, 0)} >= "
                      f"{per} x {hit['n_iter']}")
            for name, n in hit["counts"].items():
                launches[name] = launches.get(name, 0) + n
            r = dict(
                layout=layout, n_iter=host["n_iter"], blocks=blocks,
                host_ms_per_iter=least(host, host2),
                first_ms_per_iter=first["ms_per_iter"],
                second_ms_per_iter=build["ms_per_iter"],
                hit_ms_per_iter=least(hit, hit2),
                profiled_hit_ms_per_iter=pfit["ms_per_iter"],
                hit_no_collective_ms_per_iter=least(*bare[2:]),
                no_collective_first_ms_per_iter=bare[0]["ms_per_iter"],
                no_collective_second_ms_per_iter=bare[1]["ms_per_iter"],
                comm_calls=hit["comm"][0], comm_bytes=hit["comm"][1],
                host_comm_calls=host2["comm"][0],
                host_comm_bytes=host2["comm"][1],
                collectives_per_block=hi.get("collectives"),
                refused_node=refused, graph_nodes=nodes,
                hit_launch_calls=prof["launch_calls"],
                hit_graph_launches=prof["graph_launches"],
                hit_device_ms_per_iter=prof["device_ms"] / host["n_iter"],
                hit_idle_share=1.0 - prof["device_ms"] / prof["wall_ms"],
                host_launch_calls=hprof["launch_calls"],
                host_device_ms_per_iter=hprof["device_ms"] / host["n_iter"],
                host_idle_share=1.0 - hprof["device_ms"] / hprof["wall_ms"],
                infos=dict(first=fi, second=bi, hit=hi),
                launches=hit["counts"])
            log(f"  R1d {label} ({layout}): {host['n_iter']} iterations, "
                f"{blocks} eval blocks; ms/iter (host loop and hits least of "
                f"2) host loop {r['host_ms_per_iter']:.4f}, device loop: "
                f"first fit "
                f"{r['first_ms_per_iter']:.4f}, second "
                f"{r['second_ms_per_iter']:.4f}, hit "
                f"{r['hit_ms_per_iter']:.4f}, hit without its collective "
                f"{r['hit_no_collective_ms_per_iter']:.4f}; host launch "
                f"calls per fit: hit {r['hit_launch_calls']} (graph launches "
                f"{r['hit_graph_launches']}), host loop "
                f"{r['host_launch_calls']}; device ms/iter hit "
                f"{r['hit_device_ms_per_iter']:.4f} (idle "
                f"{r['hit_idle_share']:.3f}), host loop "
                f"{r['host_device_ms_per_iter']:.4f} (idle "
                f"{r['host_idle_share']:.3f}); COMM calls, bytes: device "
                f"{hit['comm']}, host {host2['comm']}; "
                f"{r['collectives_per_block']} all-reduces per captured "
                f"block; fit graph nodes {nodes}; refused node type "
                f"{refused}")
            rec[label] = r
    finally:
        setup.close()
        clear_fit_cache()  # its graphs hold the group's communicator
        dist.destroy_process_group()
    return rec, launches


def a6_phase(check, torch, est, X, make_fit, Y):
    """The estimator's utilities on the card: print_topic_terms of a
    fitted model (against topic_terms_string of its U), a
    save_model/load_model(device='cuda') round trip whose transform of
    1000 rows equals the fitted model's bit for bit, and
    utils.profiling.trace around one fit (make_fit), whose trace names
    the annotated region and the port's kernels."""
    import io
    import tempfile

    import numpy as np

    from pycmf_tpu_torch.utils import profiling
    from pycmf_tpu_torch.utils.analysis import topic_terms_string
    from pycmf_tpu_torch.utils.checkpoint import load_model, save_model

    tmp = tempfile.mkdtemp(prefix="pycmf_a6_")
    vocab = [f"term{i}" for i in range(X.shape[0])]
    out = io.StringIO()
    s = est.print_topic_terms(vocabulary=vocab, factor="U", n_top_words=8,
                              file=out)
    lines = s.splitlines()
    check(len(lines) == K and out.getvalue() == s + "\n"
          and s == topic_terms_string(est.U_, vocabulary=vocab,
                                      n_top_words=8),
          f"A6: print_topic_terms of the MU fit, {len(lines)} topics; "
          f"{lines[0] if lines else ''}")
    path = os.path.join(tmp, "mu.npz")
    t0 = time.perf_counter()
    save_model(path, est)
    back = load_model(path, device="cuda")
    io_s = time.perf_counter() - t0
    a, b = est.transform(X[:1000]), back.transform(X[:1000])
    same = bool(np.array_equal(a, b))
    check(same and back.get_params() == est.get_params()
          and np.array_equal(back.V_, est.V_),
          f"A6: save_model/load_model(device='cuda') round trip "
          f"({os.path.getsize(path)} bytes, {io_s:.2f} s): params and "
          f"factors equal, transform of 1000 rows bit for bit {same}")
    log_dir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    with profiling.trace(log_dir):
        with profiling.annotate("chip_smoke_a6_fit"):
            make_fit().fit(X, Y)
    trace_s = time.perf_counter() - t0
    files = os.listdir(log_dir)
    text = "".join(open(os.path.join(log_dir, f)).read() for f in files)
    names = sorted({w.split("(")[0] for w in text.split('"')
                    if "pycmf::" in w})
    check(len(files) == 1 and "chip_smoke_a6_fit" in text and names,
          f"A6: trace() around one fit ({trace_s:.1f} s): {len(files)} "
          f"file, {len(text)} bytes, the annotated region and "
          f"{len(names)} of the port's kernels named: {names[:4]}")
    return dict(topics=lines, checkpoint_bytes=os.path.getsize(path),
                transform_bit_equal=same, trace_bytes=len(text),
                trace_kernels=names)


API_RMSE_BAR = 1e-5       # reconstruction_rmse against float64: CSR, sigmoid
API_RMSE_BF16_BAR = 1e-4  # dense bf16 X, whose product rounds V to bf16
# float32 products at each precision: the unit roundoff of the operands'
# rounding (TF32 11 bits, bf16 8 bits) and a floor on the relative
# Frobenius error that shows the rounding took place
PRECISION_U = {"highest": 0.0, "high": 2.0 ** -11, "default": 2.0 ** -8}
PRECISION_FLOOR = {"highest": 0.0, "high": 1e-5, "default": 1e-3}
PRECISION_N = 4096  # the square product held against float64


def same_bits(torch, a, b) -> bool:
    """a and b (tensors, None, or tuples of them) hold the same bits."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(torch, x, y)
                                        for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return (a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))))


def host_rmse(X, U, V) -> float:
    """RMSE of X (sparse, its values rounded to bf16 as the card stores
    them) − U Vᵀ in float64 on the host, U and V as float32 rounds them:
    ‖X‖², the inner product at the nonzeros and the cross term of the
    k × k Grams, each in float64."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    A = sp.csr_matrix(X)
    A.sum_duplicates()
    a = torch.from_numpy(A.data.astype(np.float32)).to(
        torch.bfloat16).double().numpy()
    U = np.asarray(U, np.float32).astype(np.float64)
    V = np.asarray(V, np.float32).astype(np.float64)
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    inner = np.dot(a, np.einsum("ij,ij->i", U[rows], V[A.indices]))
    sq = np.dot(a, a) - 2.0 * inner + np.sum((U.T @ U) * (V.T @ V))
    return math.sqrt(sq / (A.shape[0] * A.shape[1]))


def host_sigmoid_rmse(Y, V, Z) -> float:
    """RMSE of Y (rounded to bf16) − σ(V Zᵀ) in float64, directly."""
    import numpy as np
    import torch

    Yq = torch.from_numpy(np.asarray(Y, np.float32)).to(
        torch.bfloat16).double().numpy()
    V = np.asarray(V, np.float32).astype(np.float64)
    Z = np.asarray(Z, np.float32).astype(np.float64)
    R = Yq - 1.0 / (1.0 + np.exp(-(V @ Z.T)))
    return math.sqrt(float(np.sum(R * R)) / R.size)


def precision_spies(check, torch, fit, targets, label):
    """fit() under set_default_precision('default') with each (module,
    name) of ``targets`` wrapped: every call runs again under 'highest' on
    the same inputs, and its outputs must hold the same bits. Returns
    fit()'s result and {name: calls}."""
    from pycmf_tpu_torch.ops.matmul import set_default_precision

    calls = {}

    def wrap(mod, attr):
        real = getattr(mod, attr)

        def spy(*a, **kw):
            out = real(*a, **kw)
            set_default_precision("highest")
            try:
                again = real(*a, **kw)
            finally:
                set_default_precision("default")
            calls.setdefault(attr, []).append(same_bits(torch, out, again))
            return out
        return spy

    with ExitStack() as stack:
        for mod, attr in targets:
            stack.enter_context(mock.patch.object(mod, attr,
                                                  wrap(mod, attr)))
        set_default_precision("default")
        try:
            out = fit()
        finally:
            set_default_precision("highest")
    names = [attr for _, attr in targets]
    check(all(calls.get(n) and all(calls[n]) for n in names),
          f"{label}: under 'default' each call of {names} equals its "
          f"'highest' self bit for bit ("
          + ", ".join(f"{n} {len(calls.get(n, []))} calls" for n in names)
          + ")")
    return out, {n: len(calls.get(n, [])) for n in names}


def api_phase(check, torch, X, Y, mu_est, c_est, b_est, make_a):
    """The reference's remaining public surface on the card: the CSR
    constructors' default device; ``ops.spmm`` on the 20NG CSR X (bf16)
    launching csr_spmm once, against csr_spmm_ref on the same tensors and
    in float64; ``reconstruction_rmse`` on path C's factors launching
    csr_rowdots once, against the plain route and a float64 host value,
    and on the MU cell's dense bf16 X and the sigmoid Y of paths A and B
    (path B's signed factors: path A's Z is all zero, σ(0) = ½) against
    float64; ``matmul`` at each precision on a 4096² float32 product
    against float64 ('highest' bit for bit today's product), no torch flag
    touched; and one step of path A under 'default' with K2-K5 (and, on
    the plain path, the sigmoid H product the reference pins to HIGHEST)
    each equal to its 'highest' self. make_a(**kw): path A's estimator."""
    import dataclasses

    import numpy as np

    from pycmf_tpu_torch import ops
    from pycmf_tpu_torch.ops import losses, sparse
    from pycmf_tpu_torch.ops.kernels import (batched_solve, newton_fused,
                                             policy, sigmoid_newton)
    from pycmf_tpu_torch.ops.kernels import spmm as kspmm

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    rec = {}

    def on_card(C):
        return all(t.device == dev for t in (C.data, C.indices, C.indptr,
                                             C.row_ids, C.sq_norm))

    Xc = ops.csr_from_scipy(X, torch.bfloat16)
    Xs = X[:2000]
    D, S = ops.csr_from_dense(Xs.toarray()), ops.csr_from_scipy(Xs)
    check(on_card(Xc) and on_card(D) and all(
        torch.equal(getattr(D, f), getattr(S, f))
        for f in ("data", "indices", "indptr", "row_ids", "sq_norm")),
        f"API: csr_from_scipy and csr_from_dense with the default device "
        f"land on {dev}; csr_from_dense of X[:2000] equals csr_from_scipy")

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    Uc, Vc = f32(c_est.U_), f32(c_est.V_)
    before = policy.launch_counts()
    got = ops.spmm(Xc, Vc)
    torch.cuda.synchronize()
    launched = policy.launches_since(before)
    e = rel_fro(got, kspmm.csr_spmm_ref(Xc, Vc))
    e64 = rel_fro(got, sparse.spmm(dataclasses.replace(
        Xc, data=Xc.data.double()), Vc.double()))
    ms = time_ms(lambda: ops.spmm(Xc, Vc), reps=5)
    check(launched == {"csr_spmm": 1} and got.dtype == torch.float32
          and tuple(got.shape) == (X.shape[0], K) and e <= 1e-5
          and e64 <= 1e-5,
          f"API: ops.spmm(X, V) on the 20NG CSR X (bf16) launched "
          f"{launched}; rel Frobenius {e:.3g} against csr_spmm_ref on the "
          f"same tensors, {e64:.3g} against float64 (<= 1e-5); {ms:.4f} ms")
    rec["spmm"] = dict(launches=launched, rel_fro=e, rel_fro_f64=e64, ms=ms)

    before = policy.launch_counts()
    r = float(losses.reconstruction_rmse(Xc, Uc, Vc, "linear"))
    launched = policy.launches_since(before)
    r_plain = float(losses.reconstruction_rmse(Xc, Uc, Vc, "linear",
                                               use_pallas=False))
    r64 = host_rmse(X, c_est.U_, c_est.V_)
    ms = time_ms(lambda: losses.reconstruction_rmse(Xc, Uc, Vc, "linear"),
                 reps=5)
    pms = time_ms(lambda: losses.reconstruction_rmse(
        Xc, Uc, Vc, "linear", use_pallas=False), reps=5)
    gap, gap64 = abs(r - r_plain) / r_plain, abs(r - r64) / r64
    check(launched == {"csr_rowdots": 1} and gap <= API_RMSE_BAR
          and gap64 <= API_RMSE_BAR,
          f"API: reconstruction_rmse on path C's factors {r!r} launched "
          f"{launched}; plain route {r_plain!r} (rel {gap:.3g}), float64 "
          f"host {r64!r} (rel {gap64:.3g}), bar {API_RMSE_BAR}; {ms:.4f} ms, "
          f"plain {pms:.4f} ms")
    rec["rmse_csr"] = dict(launches=launched, rmse=r, plain=r_plain,
                           float64=r64, ms=ms, plain_ms=pms)

    Xd = sparse.to_dense(Xc)
    Um, Vm = f32(mu_est.U_), f32(mu_est.V_)
    before = policy.launch_counts()
    r = float(losses.reconstruction_rmse(Xd, Um, Vm, "linear"))
    launched = policy.launches_since(before)
    r64 = host_rmse(X, mu_est.U_, mu_est.V_)
    gap64 = abs(r - r64) / r64
    check(not launched and gap64 <= API_RMSE_BF16_BAR,
          f"API: reconstruction_rmse on the MU cell's dense bf16 X {r!r}, "
          f"float64 host {r64!r}: rel {gap64:.3g} <= {API_RMSE_BF16_BAR} "
          f"(V rounded to bf16 in the product, as in the reference); no "
          f"kernel ({launched})")
    rec["rmse_dense_bf16"] = dict(rmse=r, float64=r64)
    del Xd

    Yd = Y.toarray() if hasattr(Y, "toarray") else np.asarray(Y)
    Yt = torch.from_numpy(np.asarray(Yd, np.float32)).to(torch.bfloat16).to(
        dev)
    r = float(losses.reconstruction_rmse(Yt, f32(b_est.V_), f32(b_est.Z_),
                                         "sigmoid"))
    r64 = host_sigmoid_rmse(Yd, b_est.V_, b_est.Z_)
    gap64 = abs(r - r64) / r64
    check(gap64 <= API_RMSE_BAR and bool(np.any(b_est.Z_)),
          f"API: reconstruction_rmse on the sigmoid Y with path B's factors "
          f"{r!r}, float64 host {r64!r}: rel {gap64:.3g} <= {API_RMSE_BAR}")
    rec["rmse_sigmoid_y"] = dict(rmse=r, float64=r64)

    # matmul at each precision, against float64
    from pycmf_tpu_torch.ops.matmul import (get_default_precision,
                                            set_default_precision)

    n = PRECISION_N
    gen = torch.Generator(device=dev).manual_seed(SEED)
    a = torch.randn(n, n, device=dev, generator=gen)
    b = torch.randn(n, n, device=dev, generator=gen)
    want = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    today = torch.matmul(a, b)
    rec["precision"] = {}
    for name, u in PRECISION_U.items():
        set_default_precision(name)
        try:
            out = ops.matmul(a, b)
            gram_ok = same_bits(torch, ops.gram(a[:, :256]),
                                ops.matmul(a[:, :256].mT, a[:, :256]))
        finally:
            set_default_precision("highest")
        err = float(((out.double() - want).abs() / scale).max())
        fro = rel_fro(out, want)
        bar = 2.0 * u + n * 2.0 ** -24  # the operands' rounding, the sums
        ms = time_ms(lambda: ops.matmul(a, b, precision=name), reps=5)
        ok = (err <= bar and fro >= PRECISION_FLOOR[name] and gram_ok
              and (name != "highest" or same_bits(torch, out, today)))
        check(ok, f"API: matmul {n}² float32 at '{name}': max |error| / "
                  f"(|a||b|) {err:.3g} <= {bar:.3g}, rel Frobenius "
                  f"{fro:.3g} >= {PRECISION_FLOOR[name]:g}"
                  + (", bit for bit today's product" if name == "highest"
                     else "") + f", gram at the setting; {ms:.4f} ms")
        rec["precision"][name] = dict(max_scaled_err=err, rel_fro=fro,
                                      ms=ms)
    raised = False
    try:
        ops.matmul(a, b[:100], precision="high")
    except RuntimeError:
        raised = True
    check(raised and get_default_precision() == "highest"
          and (torch.backends.cuda.matmul.allow_tf32,
               torch.get_float32_matmul_precision()) == flags
          and flags[0] is False,
          f"API: no torch flag read or set (allow_tf32, float32 matmul "
          f"precision {flags}), a raising product included")
    del a, b, want, scale, today, out

    # one step of path A under 'default': K2-K5 each equal their 'highest'
    # selves; the factors differ where the reference's default reaches too
    # (gram(V), matmul(M, BᵀB) in the Newton terms)
    step = dict(max_iter=1, eval_every=1, tol=0.0, loop="host")
    got, rec["k_calls"] = precision_spies(
        check, torch, lambda: make_a(**step).fit_transform(X, Y),
        ((newton_fused, "fused_newton_linear_u_pass"),
         (sigmoid_newton, "sigmoid_gh_pass"),
         (sigmoid_newton, "sigmoid_phi_pass"),
         (batched_solve, "batched_spd_solve")), "API: path A step")
    ref = make_a(**step).fit_transform(X, Y)
    gap = factor_gap(got, ref)
    check(all(bool(np.all(np.isfinite(f))) for f in got),
          f"API: path A step under 'default' finite; factor gap to "
          f"'highest' {gap:.3g} (gram(V) and matmul(M, BᵀB) follow the "
          f"default, as in the reference)")
    _, rec["plain_calls"] = precision_spies(
        check, torch,
        lambda: make_a(use_pallas=False, **step).fit_transform(X, Y),
        ((sigmoid_newton, "sigmoid_gh_rows"),), "API: plain path A step")
    rec["step_gap"] = gap
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"  API phase: {rec['seconds']:.1f} s")
    return rec


def _gloo_probe(torch, dist, dev) -> dict:
    """Which gloo collectives take tensors on ``dev`` (both ranks make the
    same calls, so an unsupported one fails on both)."""
    w = dist.get_world_size()
    probes = {
        "all_reduce": lambda t: dist.all_reduce(t),
        "broadcast": lambda t: dist.broadcast(t, src=0),
        "all_gather": lambda t: dist.all_gather(
            [torch.empty_like(t) for _ in range(w)], t),
        "all_gather_into_tensor": lambda t: dist.all_gather_into_tensor(
            torch.empty(w * t.numel(), device=dev), t),
        "reduce_scatter_tensor": lambda t: dist.reduce_scatter_tensor(
            torch.empty(t.numel() // w, device=dev), t),
    }
    out = {}
    for name, fn in probes.items():
        try:
            fn(torch.ones(8, device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        dist.barrier()
    return out


def _r2_rank(rank, store, tmp, fits, common, world=2):
    """One of phase R2's ranks (a spawned process): gloo over a FileStore,
    every rank on cuda:0, each path through CMF(n_shards=world) (or the
    fit's own n_shards and layout)."""
    import hashlib
    import pickle
    from datetime import timedelta

    import numpy as np
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                    reset_launch_counts)
    from pycmf_tpu_torch.parallel import grid as pgrid
    from pycmf_tpu_torch.parallel import sharded as psharded
    from pycmf_tpu_torch.parallel.mesh import COMM

    def never_stops(loop):
        # the fit's loop at tol -inf: no eval loss ends it (the estimator
        # takes tol >= 0 only, and under tol 0 a reported bf16 loss that
        # rises by its rounding noise, ROADMAP C2, would end the fit before
        # its single-device n_iter, which says nothing of the sharded
        # trajectory)
        def run(*args, **kw):
            return loop(*args, **dict(kw, tol=-math.inf))
        return run

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        data = {}
        for name in sorted(os.listdir(tmp)):
            base, ext = os.path.splitext(name)
            if ext == ".npz":
                data[base] = sp.load_npz(os.path.join(tmp, name))
            elif ext == ".npy":
                data[base] = np.load(os.path.join(tmp, name))
        dev = torch.device(common["device"], 0)
        out = {"probe": _gloo_probe(torch, dist, dev), "fits": {}}
        with mock.patch.object(psharded, "run_solver_loop",
                               never_stops(psharded.run_solver_loop)), \
                mock.patch.object(pgrid, "run_solver_loop",
                                  never_stops(pgrid.run_solver_loop)):
            for label, kw, xk, yk in fits:
                est = CMF(**{**common, "n_shards": world, **kw})
                COMM.reset()
                reset_launch_counts()
                t0 = time.perf_counter()
                est.fit(data[xk], data[yk])
                wall = time.perf_counter() - t0
                r = dict(n_iter=est.n_iter_, losses=est.loss_history_,
                         ms_per_iter=1e3 * sum(est.step_times_)
                         / est.n_iter_,
                         wall_s=wall, allreduce_calls=COMM.calls,
                         allreduce_bytes=COMM.nbytes,
                         launches={k: v for k, v
                                   in launch_counts().items() if v},
                         # every rank's factors, by their bytes
                         digest=hashlib.sha256(b"".join(
                             np.ascontiguousarray(f).tobytes()
                             for f in (est.U_, est.V_, est.Z_))).hexdigest())
                if rank == 0:
                    r.update(U=est.U_, V=est.V_, Z=est.Z_)
                out["fits"][label] = r
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def gloo_two_rank_phase(check, torch, data, common, fits, refs, world=2,
                        tag="R2"):
    """Phase R2 (and R2c, R2g, R2 fp8): CMF(n_shards=world) in ``world``
    spawned ranks of a gloo group, all on the one card (NCCL refuses two
    ranks on one device). data: {key: host matrix} the ranks load; fits:
    (label, kw, X key, Y key), kw overriding ``common`` (n_shards and
    shard_layout too); refs: {label: (the single-device fit's record,
    exact float64 loss of factors, {kernel: launches per iteration}[,
    {"bar": relative gap, "l0": exact loss of the initial factors,
    "spread": (low, high) exact losses}])}.
    Each fit runs as many iterations as its single-device fit and is held
    to it by the exact loss of its final factors (within 1e-4, or the
    given bar; with "spread", within that range widened by the bar; with
    "l0", also below it), every rank's loss history and
    factors equal bit for bit, and each rank's launch counts. Returns
    (record, launches of every rank)."""
    import pickle
    import tempfile

    import numpy as np
    import scipy.sparse as sp
    import torch.multiprocessing as tmp_mp

    # each fit runs its single-device fit's iterations at its own
    # eval_every, its loop at tol -inf in the ranks (never_stops): the stop
    # rule on bf16 eval losses that differ in their last bits can stop a
    # block apart, which says nothing of the sharded trajectory
    fits = [(label, dict(kw, max_iter=refs[label][0]["n_iter"], tol=0.0), xk,
             yk) for label, kw, xk, yk in fits]
    tmp = tempfile.mkdtemp(prefix="pycmf_r2_")
    t0 = time.perf_counter()
    for key, A in data.items():
        if sp.issparse(A):
            sp.save_npz(os.path.join(tmp, key + ".npz"), A.tocsr(),
                        compressed=False)
        else:
            np.save(os.path.join(tmp, key + ".npy"), np.asarray(A))
    ctx = tmp_mp.start_processes(
        _r2_rank, args=(os.path.join(tmp, "store"), tmp, fits, common,
                        world),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + R2_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{tag}'s ranks ran past {R2_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    ranks = []
    for rank in range(world):
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    wall = time.perf_counter() - t0
    rec, launches = {"probe": ranks[0]["probe"], "wall_s": wall}, {}
    log(f"  {tag}: gloo collectives on CUDA tensors: {ranks[0]['probe']}; "
        f"{wall:.1f} s for the {world} ranks, start to end")
    for label, kw, _, _ in fits:
        single, exact_loss, per, *more = refs[label]
        more = more[0] if more else {}
        bar = more.get("bar", 1e-4)
        got = [r["fits"][label] for r in ranks]
        a = got[0]
        exact = exact_loss(a["U"], a["V"], a["Z"])
        gap = abs(exact - single["exact_loss"]) / single["exact_loss"]
        same = all(g["losses"] == a["losses"] and g["digest"] == a["digest"]
                   for g in got)
        if "spread" in more:
            lo, hi = more["spread"]
            check(lo * (1 - bar) <= exact <= hi * (1 + bar) and same,
                  f"{tag} {label}: exact f64 loss {exact:.9g} after "
                  f"{a['n_iter']} iterations within [{lo:.9g}, {hi:.9g}], "
                  f"the single-device fits' over their draws, widened by "
                  f"{bar:g} (rel gap to the fit with its random_state "
                  f"{gap:.3g}); every rank's loss history and factors equal "
                  f"bit for bit: {same}")
        else:
            check(gap < bar and same,
                  f"{tag} {label}: exact f64 loss {exact:.9g} after "
                  f"{a['n_iter']} iterations vs the single-device fit's "
                  f"{single['exact_loss']:.9g} after {single['n_iter']}: rel "
                  f"gap {gap:.3g} < {bar:g}; every rank's loss history and "
                  f"factors equal bit for bit: {same}")
        if "l0" in more:
            check(exact < more["l0"],
                  f"{tag} {label}: the exact loss falls from L0 "
                  f"{more['l0']:.9g} to {exact:.9g}")
        check(a["n_iter"] == single["n_iter"],
              f"{tag} {label}: ran the single-device fit's "
              f"{single['n_iter']} iterations ({a['n_iter']})")
        for rank, r in enumerate(got):
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n
            for name, p in per.items():
                n = r["launches"].get(name, 0)
                check(n >= p * r["n_iter"],
                      f"{tag} {label}, rank {rank}: {name} launches {n} >= "
                      f"{p} x {r['n_iter']}")
        rec[label] = dict(
            n_iter=a["n_iter"], exact_loss=exact,
            single_exact_loss=single["exact_loss"],
            single_n_iter=single["n_iter"], rel_gap=gap, bar=bar,
            exact_l0=more.get("l0"),
            ms_per_iter=[g["ms_per_iter"] for g in got],
            single_ms_per_iter=single["ms_per_iter"],
            wall_s=[g["wall_s"] for g in got],
            allreduce_calls=a["allreduce_calls"],
            allreduce_bytes=a["allreduce_bytes"],
            launches=[g["launches"] for g in got])
        log(f"  {tag} {label}: "
            + " / ".join(f"{g['ms_per_iter']:.3f}" for g in got)
            + f" ms/iter on the {world} ranks (gloo through the host, one "
            f"card), single device {single['ms_per_iter']:.3f}; fit wall "
            f"{a['wall_s']:.1f} s; {a['allreduce_calls']} all-reduces, "
            f"{a['allreduce_bytes']} bytes per rank")
    return rec, launches


def _numpy_baseline(kind: str) -> tuple:
    """bench.py's NumPy baseline run (in a worker process): MU in float32,
    or Newton with a sigmoid Y link in float64. Returns (final loss,
    n_iter, seconds)."""
    import numpy as np

    from baselines import numpy_cmf
    from pycmf_tpu_torch.utils.datasets import synthetic_20ng
    from pycmf_tpu_torch.utils.init import initialize_factors

    X, Y = synthetic_20ng(random_state=SEED)
    U0, V0, Z0 = initialize_factors(X, Y, K, random_state=SEED)
    t0 = time.perf_counter()
    if kind == "mu":
        out = numpy_cmf.run_mu(
            X.astype(np.float32), Y.astype(np.float32),
            U0.astype(np.float32), V0.astype(np.float32),
            Z0.astype(np.float32), max_iter=200, tol=1e-4, eval_every=10)
    else:
        out = numpy_cmf.run_newton(
            X.astype(np.float64), Y.astype(np.float64), U0, V0, Z0,
            max_iter=50, tol=1e-5, eval_every=5, y_link="sigmoid",
            non_negative=(True, True, True))
    return float(out[4][-1]), int(out[3]), time.perf_counter() - t0


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
    import scipy.sparse as sp

    from baselines import numpy_cmf
    from pycmf_tpu_torch import CMF
    from pycmf_tpu_torch.ops.kernels import (_build, batched_solve, bell,
                                             mu_fused, mu_update,
                                             newton_fused, sigmoid_newton,
                                             spmm)
    from pycmf_tpu_torch.solvers.common import (LAST_FIT, clear_fit_cache,
                                                fit_cache_entries)
    from pycmf_tpu_torch.utils.datasets import (block_sparse_matrix,
                                                synthetic_20ng)
    from pycmf_tpu_torch.utils.init import initialize_factors

    check = Checks()
    t_start = time.perf_counter()
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
    krec = u_pass_phase(check, torch, mu_fused, newton_fused)
    krec.update(sigmoid_phase(check, torch, sigmoid_newton,
                              batched_solve))
    krec.update(k5_wide_phase(check, torch, batched_solve))
    krec.update(k5_block_lu_phase(check, torch, batched_solve))
    sigmoid_edges(check, torch, sigmoid_newton, batched_solve)
    solve_update_edges(check, torch, batched_solve, mu_update)
    krec.update(sparse_phase(check, torch))
    krec.update(fp8_u_pass_phase(check, torch, mu_fused, newton_fused))
    krec.update(fp8_sigmoid_phase(check, torch, sigmoid_newton,
                                  batched_solve))
    krec.update(fit_loop_phase(check, torch))
    krec.update(threefry_phase(check, torch))

    # 4.-7. the paths, through the estimator
    t0 = time.perf_counter()
    X, Y = synthetic_20ng(random_state=SEED)
    log(f"phase 4: data {X.shape} nnz={X.nnz} in "
        f"{time.perf_counter() - t0:.1f} s")
    X64, Y64 = X.astype(np.float64), Y.astype(np.float64)
    common = dict(n_components=K, data_dtype="bfloat16",
                  random_state=SEED, device="cuda")
    mu_kw = dict(solver="mu", max_iter=200, tol=1e-4, eval_every=10)
    mu_est, mu = fit_phase(
        check, lambda: CMF(**mu_kw, **common), X, Y,
        per_iter(fused_mu_u_pass=1, fused_mu_update=2), "MU fit",
        lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z))
    log("phase 5: Newton fit, linear links")
    nl_kw = dict(solver="newton", max_iter=30, tol=1e-5, eval_every=5)
    _, nt = fit_phase(
        check, lambda: CMF(**nl_kw, **common), X, Y,
        per_iter(fused_newton_linear_u_pass=1), "Newton linear fit",
        lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z))
    log("phase 6: path A, bench's Newton cell (sigmoid Y)")
    a_kw = dict(solver="newton", y_link="sigmoid", max_iter=50, tol=1e-5,
                eval_every=5)
    _, pa = fit_phase(
        check, lambda: CMF(**a_kw, **common), X, Y,
        per_iter(fused_newton_linear_u_pass=1, sigmoid_gh_pass=1,
                 sigmoid_phi_pass=1, batched_spd_solve=2),
        "path A fit",
        lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z,
                                       y_link="sigmoid"))
    # path A's V and Z updates hand K5 the per-row Hessians and H_shared
    # apart: the kernel adds H_shared as it reads, no (p, k, k) sum
    real_solve, shared_seen = batched_solve.batched_spd_solve, []

    def spy_solve(H, G, H_shared=None):
        shared_seen.append(H_shared is not None)
        return real_solve(H, G, H_shared)
    # (the host loop: a device fit of a cached key calls no wrapper)
    with mock.patch.object(batched_solve, "batched_spd_solve", spy_solve):
        CMF(**dict(a_kw, max_iter=2, eval_every=1, tol=0.0, loop="host"),
            **common).fit(X, Y)
    check(len(shared_seen) == 4 and all(shared_seen),
          f"path A: K5 takes H_shared apart on each of its "
          f"{len(shared_seen)} calls in 2 iterations (4 expected)")
    log("phase 7: path B, dense sigmoid X and Y")
    Xb = (X > 0).astype(np.float32)
    # signed factors: with non-negative ones every logit is >= 0, and on
    # 0.26%-dense labels the fit collapses to U = V = Z = 0 (σ = ½)
    b_kw = dict(solver="newton", x_link="sigmoid", y_link="sigmoid",
                max_iter=10, tol=0.0, eval_every=5,
                U_non_negative=False, V_non_negative=False,
                Z_non_negative=False)
    b_est, pb = fit_phase(
        check, lambda: CMF(**b_kw, **common), Xb, Y,
        per_iter(sigmoid_gh_pass=3, sigmoid_phi_pass=3, batched_spd_solve=3),
        "path B fit", card_sigmoid_loss(torch, Xb, Y))
    check(pb["reported_vs_exact_max_rel"] <= 1e-4,
          f"path B: phi eval loss vs exact f64 max rel "
          f"{pb['reported_vs_exact_max_rel']:.3g} <= 1e-4 (f32 sums of "
          f"3.4e8 squared residuals)")
    log("phase 7: path C, sparse MU (BASELINE.json config #3: CSR X)")
    c_kw = dict(solver="mu", sparse_mode="csr", max_iter=200, tol=1e-4,
                eval_every=10)
    c_est, pc = fit_phase(
        check, lambda: CMF(**c_kw, **common), X, Y,
        lambda e: {"csr_spmm": 2 * e.n_iter_,
                   "fused_mu_update": 3 * e.n_iter_, "csr_rowdots": 1},
        "path C fit", lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z))
    log("phase 7: path D, sparse Newton (bench's Newton cell on CSR X)")
    d_kw = dict(a_kw, sparse_mode="csr")
    _, pd = fit_phase(
        check, lambda: CMF(**d_kw, **common), X, Y,
        lambda e: {"csr_spmm": 2 * e.n_iter_,
                   "sigmoid_gh_pass": e.n_iter_,
                   "sigmoid_phi_pass": e.n_iter_,
                   "batched_spd_solve": 2 * e.n_iter_,
                   "csr_rowdots": len(e.loss_history_)},
        "path D fit",
        lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z, y_link="sigmoid"))
    log("phase 7: path F, block-structured X through BlockEll (MU)")
    t0 = time.perf_counter()
    Xf = block_sparse_matrix(N, M, 0.15, np.random.RandomState(SEED))
    Xf64 = Xf.astype(np.float64)
    log(f"  data {Xf.shape} nnz={Xf.nnz} in {time.perf_counter() - t0:.1f} s")
    f_kw = dict(solver="mu", sparse_mode="csr", max_iter=20, tol=0.0,
                eval_every=10)
    _, pf = fit_phase(
        check, lambda: CMF(**f_kw, **common), Xf, Y,
        lambda e: {"bell_spmm": 2 * e.n_iter_,
                   "fused_mu_update": 3 * e.n_iter_},
        "path F fit", lambda U, V, Z: numpy_cmf.loss(Xf64, Y64, U, V, Z))
    log("phase 7: CMF(n_components=40), k > 32: the MU cell and path A")
    wide_k = 40
    common_w = dict(common, n_components=wide_k)
    _, mu_w = run_fit(
        check, lambda: CMF(**mu_kw, **common_w), X, Y,
        per_iter(fused_mu_u_pass_wide=1, fused_mu_update=2), "MU fit, k=40")
    sig = lambda U, V, Z: numpy_cmf.loss(  # noqa: E731
        X64, Y64, U, V, Z, y_link="sigmoid")
    _, pa_w = run_fit_checked(
        check, lambda: CMF(**a_kw, **common_w), X, Y,
        per_iter(fused_newton_linear_u_pass_wide=1, sigmoid_gh_pass=1,
                 sigmoid_phi_pass=1, batched_spd_solve_wide=2), (),
        "path A fit, k=40", sig, "device")
    log("phase 7: path S, stochastic minibatch Newton (path A with "
        "sg_sample_ratio=0.25)")
    s_kw = dict(a_kw, sg_sample_ratio=0.25)
    fused = ("fused_newton_linear_u_pass", "sigmoid_gh_pass",
             "sigmoid_phi_pass")
    _, ps = run_fit_checked(
        check, lambda: CMF(**s_kw, **common), X, Y,
        per_iter(batched_spd_solve=2, threefry=1), fused, "path S fit", sig,
        "device")
    log(f"  path S: final exact loss {ps['exact_loss']:.9g} after "
        f"{ps['n_iter']} iterations; path A's {pa['exact_loss']:.9g} after "
        f"{pa['n_iter']}")
    log("phase 7: path S4, BASELINE.json config #4 (benchmarks/run_all.py:"
        "159-168: tall |N(0,1)| X 20000 x 1000, Y 1000 x 200, f32)")
    rs4 = np.random.RandomState(SEED)
    X4, Y4 = np.abs(rs4.randn(20000, 1000)), np.abs(rs4.randn(1000, 200))
    s4_kw = dict(solver="newton", sg_sample_ratio=0.25, tol=1e-5,
                 max_iter=30, eval_every=5)
    common4 = dict(n_components=K, random_state=SEED, device="cuda")
    _, ps4 = run_fit_checked(
        check, lambda: CMF(**s4_kw, **common4), X4, Y4,
        per_iter(threefry=1), fused, "path S4 fit",
        lambda U, V, Z: numpy_cmf.loss(X4, Y4, U, V, Z), "device")
    log("phase 7: path SD, path D (CSR X) with sg_sample_ratio=0.25: "
        "csr_spmm on B·mask, masked row norms")
    sd_kw = dict(d_kw, sg_sample_ratio=0.25)
    _, psd = run_fit_checked(
        check, lambda: CMF(**sd_kw, **common), X, Y,
        lambda e: {"csr_spmm": 4 * e.n_iter_,
                   "batched_spd_solve": 2 * e.n_iter_,
                   "csr_rowdots": len(e.loss_history_),
                   "threefry": e.n_iter_},
        ("sigmoid_gh_pass", "sigmoid_phi_pass"), "path SD fit", sig,
        "device")
    log("phase 7: path H, path A with hessian_form='full' (K5's LU route "
        "on the per-row solves, the device loop)")
    h_kw = dict(a_kw, hessian_form="full")
    h_est, ph = run_fit_checked(
        check, lambda: CMF(**h_kw, **common), X, Y,
        per_iter(fused_newton_linear_u_pass=1, batched_lu_solve=2),
        ("sigmoid_gh_pass", "sigmoid_phi_pass", "batched_spd_solve"),
        "path H fit", sig, "device")
    try:
        h_est.set_params(loop="device", use_pallas=False, max_iter=10).fit(
            X, Y)
        raised = "nothing"
    except NotImplementedError as e:
        raised = str(e)
    check("ROADMAP C3" in raised and "use_pallas=False" in raised,
          f"path H with use_pallas=False: loop='device' raises "
          f"NotImplementedError naming ROADMAP C3 ({raised[:120]}...)")
    log("phase 7: path A at k = 100 (K5's block route, the device loop)")
    common_100 = dict(common, n_components=100)
    _, pa_100 = run_fit_checked(
        check, lambda: CMF(**a_kw, **common_100), X, Y,
        per_iter(fused_newton_linear_u_pass_wide=1, sigmoid_gh_pass=1,
                 sigmoid_phi_pass=1, batched_spd_solve_block=2), (),
        "path A fit, k=100", sig, "device")

    # the streamed chunked-COO layout (sparse_mode='chunked')
    lin = lambda U, V, Z: numpy_cmf.loss(X64, Y64, U, V, Z)  # noqa: E731
    chunked = {}

    def chunked_fit(key, fn):
        # the cache's entry of an earlier path holds a copy of its data
        clear_fit_cache()
        torch.cuda.reset_peak_memory_stats()
        _, r = fn()
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["fit_cache_gb"] = sum(e.nbytes for e in fit_cache_entries()) / 1e9
        log(f"  {key}: peak device memory {r['peak_mem_gb']:.3f} GB (all "
            f"live allocations, the warm-started replay's segments "
            f"included: their second builds a cache entry), of the fit "
            f"alone {r['fit_peak_gb']:.3f} GB; the fit cache's entry holds "
            f"{r['fit_cache_gb']:.3f} GB (its graph pool apart)")
        chunked[key] = r
        return r
    log("phase 7: path K, the MU cell on the chunked layout")
    k_kw = dict(mu_kw, sparse_mode="chunked")
    with ingested_layouts() as lays:
        pk = chunked_fit("path_k_fit", lambda: fit_phase(
            check, lambda: CMF(**k_kw, **common), X, Y,
            per_iter(fused_mu_u_pass=3, fused_mu_update=2), "path K fit",
            lin))
    pk["layout"] = next(lay for lay in lays if lay)
    log(f"  path K: exact f64 loss {pk['exact_loss']:.9g} after "
        f"{pk['n_iter']} iterations; the MU cell's {mu['exact_loss']:.9g} "
        f"after {mu['n_iter']}; the fit's layout {pk['layout']}")
    log("phase 7: path KA, path A on the chunked layout")
    ka_kw = dict(a_kw, sparse_mode="chunked")
    chunked_fit("path_ka_fit", lambda: fit_phase(
        check, lambda: CMF(**ka_kw, **common), X, Y,
        per_iter(fused_newton_linear_u_pass=3, sigmoid_gh_pass=1,
                 sigmoid_phi_pass=1, batched_spd_solve=2),
        "path KA fit", sig))
    log("phase 7: path KB, path B with X and Y chunked (CSR given)")
    kb_kw = dict(b_kw, sparse_mode="chunked")
    Ysp = sp.csr_matrix(Y)
    pkb = chunked_fit("path_kb_fit", lambda: fit_phase(
        check, lambda: CMF(**kb_kw, **common), Xb, Ysp,
        per_iter(sigmoid_gh_pass=3, sigmoid_phi_pass=3, batched_spd_solve=5),
        "path KB fit", card_sigmoid_loss(torch, Xb, Y)))
    log(f"  path KB: phi eval loss vs exact f64 max rel "
        f"{pkb['reported_vs_exact_max_rel']:.3g} (path B's "
        f"{pb['reported_vs_exact_max_rel']:.3g})")
    log("phase 7: path KS, path KA with sg_sample_ratio=0.25")
    ks_kw = dict(s_kw, sparse_mode="chunked")
    chunked_fit("path_ks_fit", lambda: run_fit_checked(
        check, lambda: CMF(**ks_kw, **common), X, Y,
        per_iter(batched_spd_solve=2, threefry=1), fused, "path KS fit", sig,
        "device"))
    log("phase 7: path KR, the RCV1 surrogate as doc x term, MU, chunked "
        "and CSR")
    t0 = time.perf_counter()
    Xr = rcv1_surrogate().T.tocsr()
    log(f"  data {Xr.shape} nnz={Xr.nnz} in {time.perf_counter() - t0:.1f} "
        f"s")
    kr = {}
    # two eval blocks of 5: run_fit's fit is the first of its key (an
    # eager block, the capture, a replay); a second
    # fit builds the cache entry, a third finds it (the whole fit as one
    # launch)
    with ingested_layouts() as lays, cached_ingest():
        for mode in ("chunked", "csr"):
            kr_kw = dict(solver="mu", sparse_mode=mode, max_iter=10,
                         tol=0.0, eval_every=5)
            need = ((lambda est: per_iter(
                fused_mu_u_pass=lays[0]["chunks"], fused_mu_update=1)(est))
                if mode == "chunked"
                else per_iter(csr_spmm=2, fused_mu_update=2))
            r = chunked_fit(f"path_kr_{mode}", lambda: run_fit(
                check, lambda: CMF(**kr_kw, **common), Xr, None, need,
                f"path KR fit, {mode}"))
            r.pop("blocks")
            first = dict(LAST_FIT)
            built = CMF(**kr_kw, **common).fit(Xr)
            build = dict(LAST_FIT)
            hit = CMF(**kr_kw, **common).fit(Xr)
            check(not first["hit"] and first["eager_blocks"] == 1
                  and build["graph_launches"] == 1 and not build["hit"]
                  and LAST_FIT["hit"], f"path KR, {mode}: the first fit "
                  f"({first}), the second builds the entry ({build}), the "
                  f"third hits ({LAST_FIT})")
            r["build_ms_per_iter"] = (1e3 * sum(built.step_times_)
                                      / built.n_iter_)
            r["hit_ms_per_iter"] = 1e3 * sum(hit.step_times_) / hit.n_iter_
            r["profile"] = profile_phase(
                torch, lambda: CMF(**kr_kw, **common), Xr, None,
                f"path KR, {mode}")
            kr[mode] = r
        lay = kr["layout"] = lays[0]
        check(lays[1:] == [None], f"path KR: the chunked fit's layout {lay}, "
              f"the CSR fit's none ({lays[1:]})")
        for mode in ("chunked", "csr"):
            r = kr[mode]
            log(f"  path KR, {mode}: first fit of the key "
                f"{r['ms_per_iter']:.4f} ms/iter, the fit that builds the "
                f"entry {r['build_ms_per_iter']:.4f}, cache hit "
                f"{r['hit_ms_per_iter']:.4f} ms/iter, device "
                f"{r['profile']['device_ms_per_iter']:.4f}, idle "
                f"{r['profile']['device_idle_share']:.3f}")
        log("phase 7: path KRS, the binarised RCV1 surrogate (doc x term), "
            "sigmoid X, Newton, signed factors, no Y, sparse_mode='auto'")
        Xrb = Xr.copy()
        Xrb.data[:] = 1.0
        # one iteration (two before PR 16: the second took ~13 s and
        # checks nothing the first does not)
        krs_kw = dict(solver="newton", x_link="sigmoid", max_iter=1,
                      eval_every=1, tol=0.0, U_non_negative=False,
                      V_non_negative=False)
        from pycmf_tpu_torch.ops.kernels.policy import (launch_counts,
                                                        reset_launch_counts)
        with ingested_layouts() as kinds:
            # no warm-up fit: every kernel of the path is loaded by now
            clear_fit_cache()  # (an earlier entry holds a copy of its data)
            torch.cuda.reset_peak_memory_stats()
            est = CMF(**krs_kw, **common)
            reset_launch_counts()
            t0 = time.perf_counter()
            est.fit(Xrb)
            wall = time.perf_counter() - t0
        counts = launch_counts()
        krs = dict(n_iter=est.n_iter_, losses=est.loss_history_,
                   s_per_iter=sum(est.step_times_) / est.n_iter_,
                   wall_s=wall, launches_per_iter={
                       kk: v / est.n_iter_ for kk, v in counts.items() if v},
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   block_s=est.step_times_)
        check(len(kinds) == 1 and kinds[0] is not None,
              f"path KRS: 'auto' resolves the sigmoid-linked X past the "
              f"threshold to the chunked layout ({kinds})")
        krs["layout"] = kinds[0] or lay
        check(all(math.isfinite(v) for v in est.loss_history_)
              and est.loss_history_[-1] < est.loss_history_[0]
              and counts.get("sigmoid_gh_pass", 0)
              == krs["layout"]["chunks"] * est.n_iter_
              and counts.get("sigmoid_phi_pass", 0)
              == krs["layout"]["chunks"] * est.n_iter_,
              f"path KRS: losses {est.loss_history_} finite and falling; "
              f"K3/K4 {krs['layout']['chunks']} per iteration")
        log(f"  path KRS: {krs['s_per_iter']:.3f} s/iter (blocks "
            f"{est.step_times_} s), fit wall {wall:.1f} s, launches per "
            f"iteration {krs['launches_per_iter']}, peak device memory "
            f"{krs['peak_mem_gb']:.2f} GB")
        chunked["path_krs_fit"] = krs
        del Xrb
    chunked["path_kr"] = kr

    # fp8 data storage: X stored as e4m3 (Y at bf16), the data-pass
    # kernels' fp8 forms (K1 on MU, K2 on path A, K3 and K4 on path B)
    log("phase 7: fp8 data storage (data_dtype='fp8'): the MU cell, path A "
        "and path B")
    common8 = dict(common, data_dtype="fp8")
    Xq = quantized(torch, X)  # the data the fp8 fits fit, float64
    Xb_sp = sp.csr_matrix(Xb)  # path B's 0/1 X, densified at ingest
    fp8 = {"ingest": fp8_ingest_phase(check, torch, X, Y)}
    lin8 = lambda U, V, Z: numpy_cmf.loss(Xq, Y64, U, V, Z)  # noqa: E731
    sig8 = lambda U, V, Z: numpy_cmf.loss(  # noqa: E731
        Xq, Y64, U, V, Z, y_link="sigmoid")

    def fp8_fit(key, fn, absent):
        clear_fit_cache()  # (an earlier entry holds a copy of its data)
        torch.cuda.reset_peak_memory_stats()
        est, r = fn()
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["fit_cache_gb"] = sum(e.nbytes for e in fit_cache_entries()) / 1e9
        check(all(r["launches"].get(a, 0) == 0 for a in absent),
              f"fp8 {key}: the bf16 forms {absent} launched no time; peak "
              f"device memory {r['peak_mem_gb']:.3f} GB (all live "
              f"allocations, the replay's included), of the fit alone "
              f"{r['fit_peak_gb']:.3f} GB")
        fp8[key] = r
        return est
    mu8 = fp8_fit("mu", lambda: fit_phase(
        check, lambda: CMF(**mu_kw, **common8), X, Y,
        per_iter(fused_mu_u_pass_fp8=1, fused_mu_update=2), "MU fit, fp8",
        lin8), ("fused_mu_u_pass",))
    fp8_fit("path_a", lambda: fit_phase(
        check, lambda: CMF(**a_kw, **common8), X, Y,
        per_iter(fused_newton_linear_u_pass_fp8=1, sigmoid_gh_pass=1,
                 sigmoid_phi_pass=1, batched_spd_solve=2),
        "path A fit, fp8", sig8), ("fused_newton_linear_u_pass",))
    fp8_fit("path_b", lambda: fit_phase(
        check, lambda: CMF(**b_kw, **common8), Xb_sp, Y,
        per_iter(sigmoid_gh_pass_fp8=2, sigmoid_phi_pass_fp8=2,
                 sigmoid_gh_pass=1, sigmoid_phi_pass=1, batched_spd_solve=3),
        "path B fit, fp8", card_sigmoid_loss(torch, Xb_sp, Y)), ())
    for key, ref in (("mu", mu), ("path_a", pa), ("path_b", pb)):
        log(f"  fp8 {key}: exact f64 loss on the quantized X "
            f"{fp8[key]['exact_loss']:.9g} after {fp8[key]['n_iter']} "
            f"iterations, {fp8[key]['ms_per_iter']:.4f} ms/iter; the bf16 "
            f"fit's {ref['exact_loss']:.9g} after {ref['n_iter']}, "
            f"{ref['ms_per_iter']:.4f} ms/iter")
    log("phase 7: the estimator's default dtype (X float32): the MU cell "
        "and path A")
    common32 = dict(n_components=K, random_state=SEED, device="cuda")
    f32 = default_dtype_fits(check, torch, CMF, X, Y, mu_kw, a_kw, common32)
    log("phase 7b: where the time goes (torch.profiler)")
    f32["mu"]["profile"] = profile_phase(
        torch, lambda: CMF(**dict(mu_kw, max_iter=10, tol=0.0), **common32),
        X, Y, "MU f32")
    f32["path_a"]["profile"] = profile_phase(
        torch, lambda: CMF(**dict(a_kw, max_iter=10, tol=0.0), **common32),
        X, Y, "path A f32")
    mu["profile"] = profile_phase(
        torch, lambda: CMF(**dict(mu_kw, max_iter=10, tol=0.0), **common),
        X, Y, "MU")
    nt["profile"] = profile_phase(
        torch, lambda: CMF(**dict(nl_kw, max_iter=10, tol=0.0), **common),
        X, Y, "Newton linear")
    pa["profile"] = profile_phase(
        torch, lambda: CMF(**dict(a_kw, max_iter=10, tol=0.0), **common),
        X, Y, "path A")
    pb["profile"] = profile_phase(
        torch, lambda: CMF(**dict(b_kw, max_iter=5), **common), Xb, Y,
        "path B")
    pc["profile"] = profile_phase(
        torch, lambda: CMF(**dict(c_kw, max_iter=10, tol=0.0), **common),
        X, Y, "path C")
    pd["profile"] = profile_phase(
        torch, lambda: CMF(**dict(d_kw, max_iter=10, tol=0.0), **common),
        X, Y, "path D")
    pf["profile"] = profile_phase(
        torch, lambda: CMF(**dict(f_kw, max_iter=10), **common), Xf, Y,
        "path F")
    pa_w["profile"] = profile_phase(
        torch, lambda: CMF(**dict(a_kw, max_iter=10, tol=0.0), **common_w),
        X, Y, "path A, k=40")
    ps["profile"] = profile_phase(
        torch, lambda: CMF(**dict(s_kw, max_iter=10, tol=0.0), **common),
        X, Y, "path S")
    psd["profile"] = profile_phase(
        torch, lambda: CMF(**dict(sd_kw, max_iter=10, tol=0.0), **common),
        X, Y, "path SD")
    k7 = sum(t["ms_per_iter"] for t in pf["profile"]["top_kernels"]
             if "bell_" in t["name"])
    pf["profile"]["bell_spmm_share"] = k7 / pf["profile"]["device_ms_per_iter"]
    log(f"  path F: bell_spmm's kernels {k7:.4f} ms/iter on the device, "
        f"{pf['profile']['bell_spmm_share']:.3f} of the device time")

    log(f"phase 7c: the device loop (a key's first fit, the fit that builds "
        f"its cache entry, then hits: one launch of the cached fit graph, "
        f"sampled fits too) against the host loop; {name}, nvidia-smi: "
        f"{smi}")
    loops = {}
    with cached_ingest():
        for lab, kw, data, cm in (
                ("MU", mu_kw, (X, Y), common),
                ("Newton linear", nl_kw, (X, Y), common),
                ("path A", a_kw, (X, Y), common),
                ("path C", c_kw, (X, Y), common),
                ("path D", d_kw, (X, Y), common),
                ("path F", f_kw, (Xf, Y), common),
                ("MU k=40", mu_kw, (X, Y), common_w),
                ("path A k=40", a_kw, (X, Y), common_w),
                ("path S", s_kw, (X, Y), common),
                ("path S4", s4_kw, (X4, Y4), common4),
                ("path SD", sd_kw, (X, Y), common),
                ("path H", h_kw, (X, Y), common),
                ("path A k=100", a_kw, (X, Y), common_100),
                ("path K", k_kw, (X, Y), common),
                ("path KA", ka_kw, (X, Y), common),
                ("path KB", kb_kw, (Xb, Ysp), common),
                ("path KS", ks_kw, (X, Y), common),
                ("MU fp8", mu_kw, (X, Y), common8),
                ("path A fp8", a_kw, (X, Y), common8),
                ("MU f32", mu_kw, (X, Y), common32),
                ("path A f32", a_kw, (X, Y), common32),
                ("path B fp8", b_kw, (Xb_sp, Y), common8)):
            loops[lab] = loop_phase(
                check, torch, lambda: CMF(**kw, **cm), *data, lab,
                bits=True, miss=lab in ("MU", "path A", "path S"))
        # the draws follow the seed: the same random_state gives the same
        # fit, another random_state another (on the device loop: the
        # second same-seed fit and the other seed's are cache hits)
        for lab, kw, data, cm in (("path S", s_kw, (X, Y), common),
                                  ("path S4", s4_kw, (X4, Y4), common4),
                                  ("path SD", sd_kw, (X, Y), common),
                                  ("path KS", ks_kw, (X, Y), common)):
            clear_fit_cache()
            same = [CMF(**kw, **cm).fit(*data) for _ in range(2)]
            other = CMF(**kw, **dict(cm, random_state=SEED + 1)).fit(*data)
            check(np.array_equal(same[0].U_, same[1].U_)
                  and same[0].loss_history_ == same[1].loss_history_
                  and not np.array_equal(same[0].U_, other.U_),
                  f"{lab}: two fits with random_state={SEED} equal bit for "
                  f"bit, one with random_state={SEED + 1} differs")
        clear_fit_cache()

    # R. the row-sharded fit (n_shards): R1 on a one-rank NCCL group, R2 in
    # two gloo ranks sharing the card
    log(f"phase R1: run_sharded on a one-rank NCCL group; {name}, "
        f"nvidia-smi: {smi}")
    r1, r_launches = nccl_world1_phase(check, torch, X, Y, common, (
        ("MU", mu_kw, {"fused_mu_u_pass": 1}),
        ("path A", a_kw, {"fused_newton_linear_u_pass": 1,
                          "sigmoid_gh_pass": 1, "sigmoid_phi_pass": 1,
                          "batched_spd_solve": 2})))
    log(f"phase R1 S, K, KA: run_sharded (rows) on a one-rank NCCL group, "
        f"sampled and chunked, bit for bit with the single device; {name}, "
        f"nvidia-smi: {smi}")
    r1b, r1b_launches = nccl_world1_bits_phase(check, torch, X, Y, common, (
        ("S", s_kw, {"batched_spd_solve": 2, "threefry": 1}, (), fused,
         R1S_LOSS_BAR),
        ("K", k_kw, {"fused_mu_u_pass": pk["layout"]["chunks"],
                     "fused_mu_update": 2}, ("fused_mu_u_pass",), (), 0),
        ("KA", ka_kw, {"fused_newton_linear_u_pass": pk["layout"]["chunks"],
                       "sigmoid_gh_pass": 1, "sigmoid_phi_pass": 1,
                       "batched_spd_solve": 2},
         ("fused_newton_linear_u_pass",), (), 0)))
    for kname, n in r1b_launches.items():
        r_launches[kname] = r_launches.get(kname, 0) + n
    log("phase R2: CMF(n_shards=2), two gloo ranks on the one card (R2 S: "
        "path S sampled, each rank drawing its own columns)")
    linf = lambda U, V, Z: numpy_cmf.loss(Xf64, Y64, U, V, Z)  # noqa: E731
    s_init = initialize_factors(X, Y, K, random_state=SEED)
    # the spread of path S's exact loss over its draws: single-device fits
    # from path S's initial factors to its n_iter, R2S_SEEDS keys apart
    with cached_ingest():
        s_spread = [sig(*CMF(**dict(s_kw, max_iter=ps["n_iter"], tol=0.0,
                                    eval_every=ps["n_iter"]),
                             **dict(common, random_state=SEED + j)
                             ).fit_transform(X, Y, U=s_init[0], V=s_init[1],
                                             Z=s_init[2]))
                    for j in range(R2S_SEEDS)]
    log(f"  path S's exact loss after {ps['n_iter']} iterations from its "
        f"initial factors, random_state {SEED}..{SEED + R2S_SEEDS - 1}: "
        f"{[float(f'{v:.9g}') for v in s_spread]}")
    r2, r2_launches = gloo_two_rank_phase(
        check, torch, {"X": X, "Y": Y, "Xb": Xb, "Xf": Xf}, common,
        (("MU", mu_kw, "X", "Y"), ("path A", a_kw, "X", "Y"),
         ("path C", c_kw, "X", "Y"), ("path F", f_kw, "Xf", "Y"),
         ("path B", b_kw, "Xb", "Y"), ("path S", s_kw, "X", "Y")),
        {"MU": (mu, lin, {"fused_mu_u_pass": 1}),
         "path A": (pa, sig, {"fused_newton_linear_u_pass": 1,
                              "sigmoid_gh_pass": 1, "sigmoid_phi_pass": 1,
                              "batched_spd_solve": 2}),
         "path C": (pc, lin, {"csr_spmm": 2, "fused_mu_update": 3}),
         "path F": (pf, linf, {"bell_spmm": 2, "fused_mu_update": 3}),
         "path B": (pb, card_sigmoid_loss(torch, Xb, Y),
                    {"sigmoid_gh_pass": 3, "sigmoid_phi_pass": 3,
                     "batched_spd_solve": 3}),
         # other draws than the single device's: held within R2S_BAR of
         # the spread of its exact loss over the draws, and below the exact
         # loss of the initial factors
         "path S": (ps, sig, {"batched_spd_solve": 2},
                    {"bar": R2S_BAR, "l0": sig(*s_init),
                     "spread": (min(s_spread), max(s_spread))})})
    for kname, n in r2_launches.items():
        r_launches[kname] = r_launches.get(kname, 0) + n
    log(f"phase R1c: run_sharded(layout='cols') on a one-rank NCCL group; "
        f"{name}, nvidia-smi: {smi}")
    r1c, r1c_launches = nccl_world1_layout_phase(check, torch, Y, common, (
        ("MU", mu_kw, X, lin, {"fused_mu_update": 3}, None),
        ("path A", a_kw, X, sig, {"sigmoid_gh_pass": 1,
                                  "sigmoid_phi_pass": 1,
                                  "batched_spd_solve": 2}, None)),
        "cols", "R1c", 1e-4)
    log("phase R2c: CMF(n_shards=2, shard_layout='cols'), two gloo ranks on "
        "the one card")
    cols = dict(shard_layout="cols")
    r2c, r2c_launches = gloo_two_rank_phase(
        check, torch, {"X": X, "Y": Y, "Xb": Xb, "Xf": Xf}, common,
        (("cols MU", dict(mu_kw, **cols), "X", "Y"),
         ("cols path A", dict(a_kw, **cols), "X", "Y"),
         ("cols path C", dict(c_kw, **cols), "X", "Y"),
         ("cols path F", dict(f_kw, **cols), "Xf", "Y"),
         ("cols path B", dict(b_kw, **cols), "Xb", "Y")),
        {"cols MU": (mu, lin, {"fused_mu_update": 3}),
         "cols path A": (pa, sig, {"sigmoid_gh_pass": 1,
                                   "sigmoid_phi_pass": 1,
                                   "batched_spd_solve": 2}),
         "cols path C": (pc, lin, {"csr_spmm": 2, "fused_mu_update": 3}),
         "cols path F": (pf, linf, {"bell_spmm": 2, "fused_mu_update": 3}),
         "cols path B": (pb, card_sigmoid_loss(torch, Xb, Y),
                         {"sigmoid_gh_pass": 3, "sigmoid_phi_pass": 3,
                          "batched_spd_solve": 3})})
    log(f"phase R1g: run_grid(grid=(1, 1)) on a one-rank NCCL group (its "
        f"two axis subgroups under NCCL); {name}, nvidia-smi: {smi}")
    r1g, r1g_launches = nccl_world1_layout_phase(check, torch, Y, common, (
        ("MU", mu_kw, X, lin, {"fused_mu_update": 3}, None),
        ("path A", a_kw, X, sig, {"sigmoid_gh_pass": 1,
                                  "sigmoid_phi_pass": 1,
                                  "batched_spd_solve": 2}, None),
        # F's ms/iter beside its phase-7c host-loop fits (the grid runs the
        # host loop; a key's first device fit spreads widely, §5 of PERF.md)
        ("path F", f_kw, Xf, linf, {"bell_spmm": 2, "fused_mu_update": 3},
         dict(pf, ms_per_iter=loops["path F"]["host"]["ms_per_iter"]))),
        "grid", "R1g", 1e-5)
    log(f"phases R1c K and R1g K: path K (chunked MU) in the cols layout and "
        f"the (1, 1) grid on a one-rank NCCL group; {name}, nvidia-smi: "
        f"{smi}")
    k_ref = dict(pk, ms_per_iter=loops["path K"]["host"]["ms_per_iter"])
    r1ck, r1ck_launches = nccl_world1_layout_phase(check, torch, Y, common, (
        ("path K", k_kw, X, lin, {"fused_mu_update": 3}, k_ref),),
        "cols", "R1c K", 1e-5)
    r1gk, r1gk_launches = nccl_world1_layout_phase(check, torch, Y, common, (
        ("path K", k_kw, X, lin, {"fused_mu_update": 3}, k_ref),),
        "grid", "R1g K", 1e-5)
    log("phase R2g: CMF(n_shards=(2, 2), shard_layout='grid'), four gloo "
        "ranks on the one card")
    grid = dict(n_shards=(2, 2), shard_layout="grid")
    r2g, r2g_launches = gloo_two_rank_phase(
        check, torch, {"X": X, "Y": Y, "Xb": Xb}, common,
        (("grid MU", dict(mu_kw, **grid), "X", "Y"),
         ("grid path A", dict(a_kw, **grid), "X", "Y"),
         ("grid path C", dict(c_kw, **grid), "X", "Y"),
         ("grid path B", dict(b_kw, **grid), "Xb", "Y"),
         ("grid path K", dict(k_kw, **grid), "X", "Y")),
        {"grid MU": (mu, lin, {"fused_mu_update": 3}),
         "grid path K": (pk, lin, {"fused_mu_update": 3}),
         "grid path A": (pa, sig, {"sigmoid_gh_pass": 1,
                                   "sigmoid_phi_pass": 1,
                                   "batched_spd_solve": 2}),
         "grid path C": (pc, lin, {"csr_spmm": 2, "fused_mu_update": 3}),
         "grid path B": (pb, card_sigmoid_loss(torch, Xb, Y),
                         {"sigmoid_gh_pass": 3, "sigmoid_phi_pass": 3,
                          "batched_spd_solve": 3})}, world=4, tag="R2g")
    log(f"phase R1 fp8: run_sharded (rows) with e4m3 X on a one-rank NCCL "
        f"group; {name}, nvidia-smi: {smi}")
    r1f, r1f_launches = nccl_world1_fp8_phase(check, torch, X, Y, common8, (
        ("MU", mu_kw, {"fused_mu_u_pass_fp8": 1}, ("fused_mu_u_pass",)),
        ("path A", a_kw, {"fused_newton_linear_u_pass_fp8": 1,
                          "sigmoid_gh_pass": 1, "sigmoid_phi_pass": 1,
                          "batched_spd_solve": 2},
         ("fused_newton_linear_u_pass",))))
    log("phase R2 fp8: MU with e4m3 X in two gloo ranks, rows and grid "
        "(2, 1)")
    r2f, r2f_launches = gloo_two_rank_phase(
        check, torch, {"X": X, "Y": Y}, common8,
        (("rows MU fp8", mu_kw, "X", "Y"),
         ("grid MU fp8", dict(mu_kw, n_shards=(2, 1), shard_layout="grid"),
          "X", "Y")),
        {"rows MU fp8": (fp8["mu"], lin8, {"fused_mu_u_pass_fp8": 1}),
         "grid MU fp8": (fp8["mu"], lin8, {"fused_mu_update": 3})},
        tag="R2 fp8")
    log(f"phase R1d: the device loop under shards (loop='device', each "
        f"block's all-reduces captured into the fit's CUDA graphs) on a "
        f"one-rank NCCL group, rows, cols and the (1, 1) grid; {name}, "
        f"nvidia-smi: {smi}")
    sigmoid_y = {"sigmoid_gh_pass": 1, "sigmoid_phi_pass": 1,
                 "batched_spd_solve": 2}
    r1d, r1d_launches = nccl_world1_device_loop_phase(
        check, torch, X, Y, common, (
            ("rows MU", mu_kw, "rows", {"fused_mu_u_pass": 1,
                                        "fused_mu_update": 2}),
            ("rows path A", a_kw, "rows",
             dict(sigmoid_y, fused_newton_linear_u_pass=1)),
            ("cols path A", a_kw, "cols", sigmoid_y),
            ("grid path A", a_kw, "grid", sigmoid_y),
            ("rows path S", s_kw, "rows", {"batched_spd_solve": 2,
                                           "threefry": 1}),
            ("rows path K", k_kw, "rows",
             {"fused_mu_u_pass": pk["layout"]["chunks"],
              "fused_mu_update": 2})))
    for part in (r1c_launches, r2c_launches, r1g_launches, r2g_launches,
                 r1f_launches, r2f_launches, r1ck_launches, r1gk_launches,
                 r1d_launches):
        for kname, n in part.items():
            r_launches[kname] = r_launches.get(kname, 0) + n
    sharded = {"r1_nccl_world1": r1, "r2_gloo_two_ranks": r2,
               "r1c_nccl_world1_cols": r1c, "r2c_gloo_two_ranks_cols": r2c,
               "r1g_nccl_world1_grid": r1g, "r2g_gloo_four_ranks_grid": r2g,
               "r1_fp8_nccl_world1_rows": r1f, "r2_fp8_gloo_two_ranks": r2f,
               "r1_bits_nccl_world1_sampled_chunked": r1b,
               "r1c_k_nccl_world1_cols_chunked": r1ck,
               "r1g_k_nccl_world1_grid_chunked": r1gk,
               "r1d_nccl_world1_device_loop": r1d,
               "launches": r_launches}

    # 8. kernel path against plain path on the card; the 2% guards. The
    # NumPy baselines run on the host beside these untimed fits, after every
    # timed phase: their BLAS threads take host cores that launch kernels.
    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        base = {kind: pool.submit(_numpy_baseline, kind)
                for kind in ("newton", "mu")}
        log("phase 8: kernel path vs plain path")
        gaps20 = {}
        stepped = {"MU": None, "Newton linear": None, "path A": None}
        plain = {"fused_mu_u_pass": mu_fused,
                 "fused_newton_linear_u_pass": newton_fused,
                 "sigmoid_gh_pass": sigmoid_newton,
                 "sigmoid_phi_pass": sigmoid_newton,
                 "batched_spd_solve": batched_solve,
                 "batched_lu_solve": batched_solve,
                 "fused_mu_update": mu_update,
                 "csr_spmm": spmm, "csr_rowdots": spmm,
                 "bell_spmm": bell}
        # each matrix ingested once for both fits (path F's ~12 s)
        with cached_ingest():
            for label, kw, data in (
                    ("MU", dict(mu_kw, max_iter=20, tol=0.0), (X, Y)),
                    ("Newton linear", dict(nl_kw, max_iter=20, tol=0.0),
                     (X, Y)),
                    ("path A", dict(a_kw, max_iter=20, tol=0.0), (X, Y)),
                    ("path B", b_kw, (Xb, Y)),
                    ("path C", dict(c_kw, max_iter=20, tol=0.0), (X, Y)),
                    ("path D", dict(d_kw, max_iter=20, tol=0.0), (X, Y)),
                    ("path F", f_kw, (Xf, Y))):
                lk = CMF(**kw, **common).fit(*data).reconstruction_err_
                # the plain path on the host loop: a capture refuses the
                # plain batched solve (MAGMA); the device loop ends where
                # the host loop does, bit for bit (phase 7c)
                with ExitStack() as patches:
                    for fn, mod in plain.items():
                        patches.enter_context(mock.patch.object(
                            mod, fn, getattr(mod, fn + "_ref")))
                    lp = CMF(**kw, **common, loop="host").fit(
                        *data).reconstruction_err_
                gap = abs(lk - lp) / abs(lp)
                gaps20[label] = gap
                what = (f"{label}: kernel {lk:.9g} vs plain {lp:.9g} after "
                        f"{kw['max_iter']} iterations, rel gap {gap:.3g}")
                if label in stepped:  # dense bf16: held step by step below
                    log(f"  {what} (printed; the per-step check holds this "
                        f"path)")
                else:
                    check(gap <= 1e-3, f"{what} <= 1e-3")
        # sampled steps: a fresh fit draws under the key of its
        # random_state, so both paths of a step make the same draws
        # (recorded and compared)
        from pycmf_tpu_torch.solvers import newton as tnewton
        draw, drawn = tnewton.choice_without_replacement, []

        def recorded(key, q, s):
            drawn.append(draw(key, q, s))
            return drawn[-1]
        for label, kw in (("path S", s_kw), ("path SD", sd_kw)):
            drawn.clear()
            with mock.patch.object(tnewton, "choice_without_replacement",
                                   recorded):
                stepped[label] = step_agreement(
                    check, lambda: CMF(**kw, **common), X, Y, K, plain,
                    label, sig, 4, 1e-3)
            per_fit = len(drawn) // 8
            check(per_fit > 0 and all(
                bits_equal(torch, a, b) for a, b in zip(
                    drawn, drawn[:per_fit] * 8)) and len(drawn) == 8 * per_fit,
                f"{label}: the kernel and the plain step drew the same "
                f"columns ({per_fit} draws per step)")
        for label, kw, kk, loss, steps, bar in (
                ("MU", mu_kw, K, lin, 20, 1e-4),
                ("Newton linear", nl_kw, K, lin, 20, 1e-3),
                ("path A", a_kw, K, sig, 20, 1e-3),
                ("MU k=40", mu_kw, wide_k, lin, 10, 1e-4),
                ("path A k=40", a_kw, wide_k, sig, 10, 1e-3),
                ("path K", k_kw, K, lin, 3, 1e-4),
                ("path KA", ka_kw, K, sig, 3, 1e-3)):
            stepped[label] = step_agreement(
                check, lambda: CMF(**kw, **dict(common, n_components=kk)),
                X, Y, kk, plain, label, loss, steps, bar)
        # fp8: kernel vs plain step by step, and each fp8 fit against the
        # bf16 fit of the quantized X (bit for bit)
        stepped["MU fp8"] = step_agreement(
            check, lambda: CMF(**mu_kw, **common8), X, Y, K, plain,
            "MU fp8", lin8, 5, 1e-4)
        stepped["path A fp8"] = step_agreement(
            check, lambda: CMF(**a_kw, **common8), X, Y, K, plain,
            "path A fp8", sig8, 5, 1e-3)
        for label, kw, data in (
                ("MU fp8", dict(mu_kw, max_iter=20, tol=0.0), (X, Xq, Y)),
                ("path A fp8", dict(a_kw, max_iter=20, tol=0.0),
                 (X, Xq, Y)),
                ("path B fp8", b_kw, (Xb_sp, Xb_sp, Y))):
            fp8[f"{label} vs bf16"] = fp8_matches_bf16(
                check, lambda: CMF(**kw, **common8),
                lambda: CMF(**kw, **common), *data, label)[2]
        stepped["path K vs dense"] = step_vs_dense(
            check, lambda: CMF(**k_kw, **common), X, Y, K, "path K", 1e-4)
        # path A at k = 100, the one fit on K5's block route: whole steps
        # with K2's U_new shared (both paths launch K2, so V's and Z's steps
        # start from the same U_new and hold K3, K4 and K5's block route),
        # then what the plain U step alone changes (shared_u_step)
        a100 = lambda: CMF(**a_kw, **common_100)  # noqa: E731
        stepped["path A k=100"] = shared_u_step(
            check, a100, X, Y, 100, plain, "path A k=100", sig, 3, 1e-3)
        # and K5's block route on the fit's own systems, each call against
        # its plain version (the host loop: a capture would take the plain
        # Cholesky into the graph)
        real_solve, block_errs = batched_solve.batched_spd_solve, []

        def held_solve(H, G, H_shared=None):
            out = real_solve(H, G, H_shared)
            if H.shape[-1] > batched_solve.MAX_K:
                want = batched_solve.batched_spd_solve_ref(H, G, H_shared)
                block_errs.append(rel_fro(out, want))
            return out
        with mock.patch.object(batched_solve, "batched_spd_solve",
                               held_solve):
            CMF(**dict(a_kw, max_iter=3, eval_every=1, tol=0.0,
                       loop="host"), **common_100).fit(X, Y)
        check(len(block_errs) == 6 and max(block_errs) <= 1e-3,
              f"path A k=100: K5's block route on the fit's systems (Z's 20 "
              f"and V's 11314 per step, 3 steps) against its plain version, "
              f"rel Frobenius max {max(block_errs):.3g} <= 1e-3 "
              f"({len(block_errs)} calls)")
        stepped["path A k=100 block route"] = max(block_errs)
        t0 = time.perf_counter()
        baseline = {kind: f.result() for kind, f in base.items()}
        log(f"host baselines awaited {time.perf_counter() - t0:.1f} s")
        for label, kind, fit, lkey in (
                ("MU", "mu", mu, "loss"), ("path A", "newton", pa, "loss"),
                ("path C", "mu", pc, "loss"), ("path D", "newton", pd, "loss"),
                ("MU f32 (exact loss)", "mu", f32["mu"], "exact_loss"),
                ("path A f32 (exact loss)", "newton", f32["path_a"],
                 "exact_loss")):
            ref_loss, ref_iter, secs = baseline[kind]
            gap = abs(fit[lkey] - ref_loss) / ref_loss
            check(gap <= QUALITY_BAR,
                  f"{label} final loss {fit[lkey]:.9g} vs NumPy {kind} "
                  f"baseline "
                  f"{ref_loss:.9g} ({ref_iter} iters, {secs:.1f} s on the "
                  f"host): gap {gap:.4%} <= 2%")
            fit["numpy_loss"], fit["numpy_n_iter"] = ref_loss, ref_iter

    # 9. transform, dense (MU) and CSR (path C)
    for est, tag in ((mu_est, "MU"), (c_est, "path C, CSR"),
                     (mu8, "MU, fp8")):
        Ut = est.transform(X[:1000])
        check(Ut.shape == (1000, K) and bool(np.all(np.isfinite(Ut))),
              f"{tag}: transform(X[:1000]) -> {Ut.shape}, finite")
    log("phase 9: the estimator's utilities (A6) on the card")
    a6 = a6_phase(check, torch, mu_est, X, lambda: CMF(
        **dict(mu_kw, max_iter=10, tol=0.0), **common, loop="host"), Y)
    log("phase 10: the reference's remaining public surface (A13)")
    api = api_phase(check, torch, X, Y, mu_est, c_est, b_est,
                    lambda **kw: CMF(**dict(a_kw, **kw), **common))

    total_s = time.perf_counter() - t_start
    log(f"chip_smoke: {total_s:.1f} s from the device query to the record "
        f"(the build, the data and every phase)")
    if check.failed:
        log(f"chip_smoke: {len(check.failed)} check(s) failed: "
            + "; ".join(check.failed))
        return 1
    src = "pycmf_tpu_torch/csrc/"
    api_launches = {
        "csr_spmm": api["spmm"]["launches"].get("csr_spmm", 0),
        "csr_rowdots": api["rmse_csr"]["launches"].get("csr_rowdots", 0)}
    kernels = []
    for kname, file, replaces, main, fit, extra in (
            ("fused_mu_u_pass", "mu_fused.cu", ("mu_fused.py:143",),
             ("fused_mu_u_pass", "bfloat16"), mu,
             {"f32": ("fused_mu_u_pass", "float32")}),
            ("fused_newton_linear_u_pass", "newton_fused.cu",
             ("newton_fused.py:179",),
             ("fused_newton_linear_u_pass", "bfloat16"), pa,
             {"f32": ("fused_newton_linear_u_pass", "float32")}),
            # the fp8 forms at k <= 32; e4m3 X at k > 32 runs the wide
            # route (u_pass_wide.cu) and counts under <kernel>_wide
            ("fused_mu_u_pass_fp8", "mu_fused.cu", ("mu_fused.py:143",),
             ("fused_mu_u_pass", "fp8", K), fp8["mu"], {}),
            ("fused_newton_linear_u_pass_fp8", "newton_fused.cu",
             ("newton_fused.py:179",),
             ("fused_newton_linear_u_pass", "fp8", K), fp8["path_a"], {}),
            # the wide route (k > 32, every X dtype): MU and path A at
            # k = 40, path A at k = 100
            ("fused_mu_u_pass_wide", "u_pass_wide.cu", ("mu_fused.py:143",),
             ("fused_mu_u_pass_wide", "bfloat16", 40), mu_w,
             {"k100": ("fused_mu_u_pass_wide", "bfloat16", 100),
              "f32_k40": ("fused_mu_u_pass_wide", "float32", 40),
              "f32_k100": ("fused_mu_u_pass_wide", "float32", 100),
              "fp8_k40": ("fused_mu_u_pass", "fp8", 40)}),
            ("fused_newton_linear_u_pass_wide", "u_pass_wide.cu",
             ("newton_fused.py:179",),
             ("fused_newton_linear_u_pass_wide", "bfloat16", 40),
             {"launches": {"fused_newton_linear_u_pass_wide": sum(
                 f["launches"].get("fused_newton_linear_u_pass_wide", 0)
                 for f in (pa_w, pa_100))}},
             {"k100": ("fused_newton_linear_u_pass_wide", "bfloat16", 100),
              "f32_k40": ("fused_newton_linear_u_pass_wide", "float32", 40),
              "f32_k100": ("fused_newton_linear_u_pass_wide", "float32",
                           100),
              "fp8_k40": ("fused_newton_linear_u_pass", "fp8", 40)}),
            ("sigmoid_gh_pass_fp8", "sigmoid_newton.cu",
             ("sigmoid_newton.py:94",), ("sigmoid_gh_pass", "B[fp8]"),
             fp8["path_b"], {"t": ("sigmoid_gh_pass", "Bt[fp8]")}),
            ("sigmoid_phi_pass_fp8", "sigmoid_newton.cu",
             ("sigmoid_newton.py:176",), ("sigmoid_phi_pass", "B[fp8]"),
             fp8["path_b"], {"t": ("sigmoid_phi_pass", "Bt[fp8]")}),
            ("sigmoid_gh_pass", "sigmoid_newton.cu",
             ("sigmoid_newton.py:94",),
             ("sigmoid_gh_pass", "A[bfloat16]"), pa,
             {"b": ("sigmoid_gh_pass", "B[bfloat16]"),
              "b_f32": ("sigmoid_gh_pass", "B[float32]")}),
            ("sigmoid_phi_pass", "sigmoid_newton.cu",
             ("sigmoid_newton.py:176",), ("sigmoid_phi_pass", "A[bfloat16]"),
             pa,
             {"b": ("sigmoid_phi_pass", "B[bfloat16]"),
              "b_f32": ("sigmoid_phi_pass", "B[float32]")}),
            ("batched_spd_solve", "batched_solve.cu", ("batched_solve.py:71",),
             ("batched_spd_solve", M), pa,
             {"p30000": ("batched_spd_solve", N)}),
            ("batched_spd_solve_wide", "batched_solve_wide.cu",
             ("batched_solve.py:71",),
             ("batched_spd_solve_wide", M, 40), pa_w,
             {(f"k{k}" if p == M else f"p{p}_k{k}"):
              ("batched_spd_solve_wide", p, k)
              for k in WIDE_K for p in WIDE_P if (p, k) != (M, 40)}),
            ("batched_spd_solve_block", "batched_solve.cu",
             ("batched_solve.py:74",),
             ("batched_spd_solve_block", M, 100), pa_100,
             {(f"k{k}" if p == M else f"p{p}_k{k}"): (n, p, k)
              for n, p, k, _ in k5_block_cases(krec)
              if n == "batched_spd_solve_block" and (p, k) != (M, 100)}),
            ("batched_lu_solve", "batched_solve.cu",
             ("pycmf_tpu/solvers/newton.py:308",),
             ("batched_lu_solve", M, 20, "spd"), ph,
             {(f"{kind}_k{k}" if p == M else f"p{p}_{kind}_k{k}"):
              (n, p, k, kind) for n, p, k, kind in k5_block_cases(krec)
              if n == "batched_lu_solve" and (p, k, kind) != (M, 20, "spd")}),
            ("fused_mu_update", "mu_update.cu", ("mu_update.py:41",),
             f"fused_mu_update[{M}x{K}]", pc,
             {"rcv1": "fused_mu_update[804414x20]"}),
            ("csr_spmm", "csr_spmm.cu",
             ("onehot.py:356", "onehot.py:311", "spmm.py:170"),
             "csr_spmm[20ng,bfloat16] X V", pc,
             {"t": "csr_spmm[20ng,bfloat16] Xt U",
              "f32": "csr_spmm[20ng,float32] X V",
              "rcv1": "csr_spmm[rcv1,bfloat16] X V",
              "rcv1_t": "csr_spmm[rcv1,bfloat16] Xt U"}),
            ("csr_rowdots", "csr_spmm.cu", ("spmm.py:230",),
             "csr_rowdots[20ng,bfloat16]", pd,
             {"f32": "csr_rowdots[20ng,float32]",
              "rcv1": "csr_rowdots[rcv1,bfloat16]"}),
            ("bell_spmm", "bell_spmm.cu", ("bell.py:163",),
             "bell_spmm[full,bfloat16]", pf,
             {"f32": "bell_spmm[full,float32]",
              "t": "bell_spmm[fullT,bfloat16]",
              "t_f32": "bell_spmm[fullT,float32]"})):
        r = krec[main]
        entry = {"name": kname, "route": "cuda", "source": src + file,
                 "replaces": ", ".join(
                     f if f.startswith("pycmf_tpu/") else
                     "pycmf_tpu/ops/pallas/" + f for f in replaces),
                 "launches": (fit["launches"].get(kname, 0)
                              + r_launches.get(kname, 0)),
                 "sharded_launches": r_launches.get(kname, 0),
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 # the contract's two kinds; which operations (tensor
                 # cores, sigmoids) in bound_detail
                 "bound_by": ("bytes" if r["bound_by"] == "bytes"
                              else "operations"),
                 "bound_detail": r["bound_by"],
                 "library_ms": r.get("library_ms")}
        if kname.endswith("_wide"):  # launches per path: MU, A at 40, 100
            entry["launches_by_path"] = {
                lab: f["launches"].get(kname, 0) for lab, f in (
                    ("mu_k40", mu_w), ("path_a_k40", pa_w),
                    ("path_a_k100", pa_100))}
        if kname in api_launches:  # phase 10's calls: ops.spmm, the RMSE
            entry["api_launches"] = api_launches[kname]
        if kname in ("fused_mu_u_pass", "fused_newton_linear_u_pass"):
            # the default dtype's fits (MU f32, A f32): the f32 form
            entry["f32_launches"] = sum(
                r32["launches"].get(kname, 0) for r32 in f32.values())
        for f in ("device_ms", "library_device_ms", "shared_ms",
                  "shared_device_ms", "bf16_form_ms", "bf16_form_device_ms",
                  "equal_to_bf16_form"):
            if r.get(f) is not None:
                entry[f] = r[f]
        for pre, key in extra.items():
            for f in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                      "library_ms", "device_ms", "library_device_ms",
                      "shared_ms", "shared_device_ms", "bf16_form_ms",
                      "bf16_form_device_ms", "equal_to_bf16_form"):
                if f in krec[key]:
                    entry[f"{pre}_{f}"] = krec[key][f]
        kernels.append(entry)
    r = krec["fit_loop"]
    kernels.append({
        "name": "fit_loop", "route": "cuda", "source": src + "fit_loop.cu",
        "replaces": "pycmf_tpu/solvers/common.py:223 (lax.while_loop of "
                    "device_fit_core: its cond and stop rule; no Pallas "
                    "kernel)",
        "launches": mu["launches"].get("fit_loop", 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_ms": r["device_ms"],
        "graph_us_per_block": r["graph_us_per_block"]})
    # not a TPU kernel: the reference's random stream (jax.random's
    # Threefry-2x32), the draws of every sampled path
    r = krec["threefry[30000]"]
    kernels.append({
        "name": "threefry", "route": "cuda", "source": src + "threefry.cu",
        "replaces": "pycmf_tpu/solvers/newton.py:115-143 (jax.random.choice "
                    "under the reference's key schedule, Threefry-2x32; no "
                    "Pallas kernel)",
        "launches": ps["launches"].get("threefry", 0),
        "launches_per_iter": {
            lab: p["launches"].get("threefry", 0) / p["n_iter"]
            for lab, p in (("S", ps), ("S4", ps4), ("SD", psd))},
        "sharded_launches": r_launches.get("threefry", 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_ms": r["device_ms"],
        **{f"n804414_{f}": krec["threefry[804414]"][f]
           for f in ("ms", "device_ms", "plain_ms", "bound_ms")},
        "step_keys_ms": krec["threefry[step_keys]"]["ms"],
        "step_keys_device_ms": krec["threefry[step_keys]"]["device_ms"],
        **{f"choice_{q}_{s}_ms": krec[f"choice[{q},{s}]"]["ms"]
           for q, s in CHOICE_DIGESTS},
        "graph_nodes": krec["threefry_graph"]["nodes"]})
    record = json.dumps({"mu_fit": mu, "newton_linear_fit": nt,
                      "path_a_fit": pa, "path_b_fit": pb, "path_c_fit": pc,
                      "path_d_fit": pd, "path_f_fit": pf,
                      "mu_fit_k40": mu_w, "path_a_fit_k40": pa_w,
                      "path_s_fit": ps, "path_s4_fit": ps4,
                      "path_sd_fit": psd, "path_h_fit": ph,
                      "path_a_fit_k100": pa_100, "chunked": chunked,
                      "fp8": fp8, "f32": f32,
                      "block_max_k": krec["block_max_k"],
                      "k5_crossovers": {key: krec[key] for key in (
                          "block_max_k", "block_max_k_lu", "slot_all_k",
                          "slot_all_k_lu")},
                      "device_vs_host_loop": loops,
                      "phase8_gap_after_20": gaps20,
                      "sharded": sharded, "utilities": a6, "api": api,
                      "seconds": total_s,
                      "phase8_step_gap_max": stepped,
                      "bell_crossover": {k: v for k, v in krec.items()
                                         if str(k).startswith("crossover")}})
    log(f"record: {record}")  # whole, where standard output is cut short
    print(record)
    print(f"{name} | nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
