#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (di_hpc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # no arguments; needs one CUDA card

Phases, each printing one JSON line (`{"phase": ...}`):

  1. device  -- torch, CUDA and nvcc versions; the card's name and power
                limit as nvidia-smi gives them.
  2. build   -- builds every CUDA kernel of the port from this checkout's
                sources (nvcc, one process per source, in parallel) and
                prints the build time and ptxas' registers, shared memory
                and spills.
  3. kernels -- calls each kernel on the card at the main paths' shapes and
                holds it against its plain PyTorch version on the same
                inputs (float32 without TF32 on both sides); times both with
                CUDA events (median over repetitions): a kernel's `ms` is one
                call after the L2 was flushed, `ms_l2_warm` back-to-back
                calls.  The LSTM backward kernels run at the train step's
                shapes (V2 at S=33, B=256, V1 at S=33, B=32, H=512); V2 must
                be bitwise repeatable; the layer's autograd.Function (stash
                forward, backward kernels) is held against autograd through
                the plain forward.  The scan kernels (gae, lambda_returns,
                td_lambda_loss, td_lambda_err, linear_scan both ways with a
                zero, a scalar and a (B,) boundary, upgo_advantages,
                upgo_loss) run at T=1024, B=4096, at a ragged B and at T=1;
                td_lambda_loss and upgo_loss must be bitwise repeatable.
  4. slice   -- the forward and serving path at full width, through the
                entry points a user calls, with every launch count set to 0
                just before it and read just after: the LN-LSTM
                actor-critic (obs 256, hidden 512, 2 layers, 64 actions;
                random weights from a numpy seed) runs
                `actor_critic_forward` over a (33, 256) unroll,
                `ops.vtrace_error` on its logits and values (unit weight and
                weighted), 64 `actor_step` serving calls at B=256 with the
                state carried, and `ops.vtrace_error` at T=1024, B=4096,
                N=32 (unit weight and weighted).  Outputs must be finite, of
                the expected shapes, every kernel of the path must have been
                launched, and each output must agree with the same call's
                plain PyTorch run on the CPU.  Then ms per forward, per
                serving step and per V-trace call (host clock around
                synchronized work).
  5. train   -- the training path: one `models.make_train_step` step (forward
                with the stash, V-trace loss, the backward kernels, Adam) at
                the same full width, T=32, B=256 (the V2 backward), counts
                set to 0 just before and read just after; the metrics and
                every parameter's gradient against the same step on the CPU
                (plain versions); then ms per train step (host clock around
                synchronized work, median of 7 steps).  A second leg at
                B=32 routes the backward through V1 and is checked the same
                way, so every ported kernel launches on one of the paths.
  6. onpolicy -- the on-policy learner path, counts set to 0 just before it
                and read just after: `ops.gae` (T=1024, B=4096),
                `ops.td_lambda_error` (unit weight with the gradient in
                value, and a (B,) weight), `ops.ppo_error_with_logp_old`
                and `ops.ppo_error` with their gradients (B=4096, N=128),
                then the PPO trainer of examples/ppo_training.py (obs 32,
                hidden 64, 128 actions, rollouts T=16, B=256; 2 iterations
                of GAE, logp_old and 4 Adam epochs).  Every output, each
                epoch's metrics and gradients and the final parameters
                against the same calls on the CPU; then ms per GAE call, per
                TD(lambda) forward + backward and per PPO iteration.
  7. upgo    -- the scan entry points, UPGO and the AlphaStar path, counts
                set to 0 just before it and read just after:
                `ops.linear_recurrence_{reverse,forward}` ("auto") and
                `ops.generalized_lambda_returns` with (T, B) gamma and lambda
                planes at T=1024, B=4096, `ops.upgo_returns` at that shape,
                `ops.upgo_loss` with its gradient at T=128, B=512, N=128,
                `network.scatter_connection` (add and cover) with its
                gradient at B=M=N=256, 16x16, then 3 steps of the train step
                of examples/alphastar_policy_training.py (its configuration:
                T=16, B=8, 32 entities, a 128-wide LN-LSTM core, 6 greedy
                selections; Adam(lr=3e-4); synthetic batches).  Every output,
                each step's metrics and gradients and the final parameters
                against the same calls on the CPU; then ms per UPGO loss
                forward + backward, per scatter add + gradient and per
                AlphaStar train step.
  8. profile -- torch.profiler over one more run of each of the timed calls
                (forward, serving loop, V-trace, train step, the three
                on-policy calls, the UPGO loss and the AlphaStar train
                step): device busy time, idle share of the window and the
                top kernels by device time.

Then one `{"kernels": [...]}` line, the nvidia-smi line, and, last, the
contract line `{"ok": true, "device": {...}}`.  Any failure prints its phase
with `"ok": false` and exits 1; no card (or no port beside this script)
exits non-zero before any result.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Without the rest of the repository beside this script, this import fails
# and the run ends before it prints anything.
from di_hpc_tpu_torch import (  # noqa: E402
    kernels, models, network, ops, origin)
from di_hpc_tpu_torch.kernels import _build  # noqa: E402

# H100 SXM data sheet peaks (dense, 700 W): HBM bytes/s and float32 FLOP/s
# outside the tensor cores.  The kernels here are float32 FMA code.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Kernel vs plain version, both float32 on the card (TF32 off): they differ
# in summation order (the kernel's k-loop and warp sums against cuBLAS and
# PyTorch's reduction trees) and in FMA contraction, carried through the
# recurrences.  The same bound holds the card's path against the CPU's.
RTOL, ATOL = 1e-4, 1e-4
# The LSTM backward's outputs (the kernels against their plain versions, the
# autograd.Function against autograd through the plain forward) add
# BWD_ATOL_REL times the output's largest |entry| to ATOL: the reverse loop
# carries every step's rounding into all earlier steps, through dh = dg_pre
# Wh^T and the LayerNorm backward's 1/std factor, and its parameter sums
# add all S*B rows in another order, so an entry's error follows its
# tensor's scale rather than its own size.
BWD_ATOL_REL = 5e-5

SEED = 20261016


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, per_rep: int = 1, warmup: int = 2) -> float:
    """Median over `reps` of the CUDA-event time of `per_rep` calls, per
    call, in ms.  Back to back: a call may find its inputs in the L2 that
    the call before it filled."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


# Written between the timed calls of cold_ms: five times the H100's 50 MB L2.
L2_FLUSH_BYTES = 256 * 2 ** 20
# A spin after the flush, so that the card is still busy while the host
# enqueues the timed call (~0.2 ms at the H100's clocks): the start event
# then waits on the card, not on the host.
SPIN_CYCLES = 400_000


def cold_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median over `reps` of the CUDA-event time of one call of fn, each
    after a write of an L2_FLUSH_BYTES scratch buffer and a spin, both
    outside the timed events: the call finds none of its inputs in the L2,
    as a caller that did other work before it would."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        scratch.fill_(1.0)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def kernel_ms(fn, per_rep: int) -> dict:
    """A kernel row's times: `ms` with a cold L2 (cold_ms) and, beside it,
    `ms_l2_warm` from back-to-back calls (cuda_ms, 7 x per_rep calls)."""
    return {"ms": cold_ms(fn), "ms_l2_warm": cuda_ms(fn, 7, per_rep=per_rep)}


def host_ms(fn, reps: int) -> float:
    """Median over `reps` calls of the host-clock time of fn() between two
    synchronizes, in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def compare(name, got, want, rtol=RTOL, atol=ATOL, atol_rel=0.0) -> dict:
    """Max abs/rel error of got against want, and the largest max|got -
    want| / max|want| of a pair; raises past the tolerance, |got - want| <=
    atol + atol_rel * max|want| + rtol * |want| for each pair of tensors."""
    abs_err, rel_err, scaled_err, bad = 0.0, 0.0, 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}[{i}]: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)} or non-finite values")
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / w.abs().clamp_min(1e-30)).max()))
        scale = float(w.abs().max())
        scaled_err = max(scaled_err, float(d.max()) / max(scale, 1e-30))
        if not bool((d <= atol + atol_rel * scale + rtol * w.abs()).all()):
            bad.append(i)
    result = {"max_abs_err": abs_err, "max_rel_err": rel_err,
              "max_err_over_max": scaled_err}
    if bad:
        raise AssertionError(f"{name}: outputs {bad} outside rtol={rtol}, "
                             f"atol={atol} + {atol_rel} * max|want|: "
                             f"{result}")
    return result


def phase_device() -> dict:
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc.stdout.strip().splitlines()[-1],
            "python": sys.version.split()[0],
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi()}


def phase_build() -> dict:
    start = time.perf_counter()
    lib = _build.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "ptxas" in ln or "spill" in ln]
    return {"library": os.path.relpath(lib.path, ROOT),
            "build_s": lib.build_seconds,
            "load_s": time.perf_counter() - start,
            "flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas}


# ------------------------------------------------------------ phase 3 ----

def lstm_inputs(rng, S, B, H, dev):
    G = 4 * H
    g = 1.0 / np.sqrt(H)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)
    arrays = (n(S, B, G), rng.uniform(-g, g, (H, G)).astype(np.float32),
              1 + 0.1 * n(G), 0.1 * n(G), 1 + 0.1 * n(G), 0.1 * n(G),
              0.1 * n(G), 0.5 * n(B, H), 0.5 * n(B, H))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def lstm_bound(S, B, H):
    G = 4 * H
    nbytes = 4 * (S * B * G + H * G + 5 * G + 2 * B * H      # in
                  + S * B * H + 2 * B * H)                   # out
    flops = 2 * S * B * H * G                                # h @ Wh
    return nbytes, flops


def lstm_bwd_bound(variant, S, B, H):
    """(bytes, ops) of the V2 or V1 backward function: each input read once
    (V2 reads y and c_seq at steps 0..S-2 only), each output written once;
    V2 does two products with Wh per step (the gh_pre recompute and dh =
    dg_pre @ Wh^T), V1 one.  LayerNorm and gate math, a few percent of the
    operations, are not counted."""
    G = 4 * H
    if variant == "v2":
        ctas = (B + 7) // 8
        return (4 * (S * B * G + 2 * (S - 1) * B * H + S * B * H + H * G
                     + 5 * G + 4 * B * H                             # in
                     + 2 * S * B * G + ctas * 3 * G + 2 * B * H),    # out
                4 * S * B * H * G)
    return (4 * (2 * S * B * G + 3 * S * B * H + H * G + 2 * G + 2 * B * H
                 + 2 * S * B * G + 2 * B * H),
            2 * S * B * H * G)


def vtrace_inputs(rng, T, B, dev):
    arrays = (np.exp(0.3 * rng.standard_normal((T, B), dtype=np.float32)),
              -np.abs(rng.standard_normal((T, B), dtype=np.float32)),
              rng.standard_normal((T, B), dtype=np.float32),
              rng.standard_normal((T + 1, B), dtype=np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def vtrace_bounds(T, B):
    """(bytes, ops) of the losses and returns/adv kernels: each input read
    once, each output written once; 20 and 15 f32 operations per element."""
    losses = (4 * (3 * T * B + (T + 1) * B + 2 * B), 20 * T * B)
    returns = (4 * (2 * T * B + (T + 1) * B + 2 * T * B), 15 * T * B)
    return losses, returns


def scan_bounds(T, B):
    """(bytes, ops) of the four row-constant scan kernels: each input read
    once (denom (T,) for GAE), each output written once; 6, 4, 7 and 5 f32
    operations per element."""
    inputs = (T + 1) * B + T * B
    return {"gae": (4 * (inputs + T + T * B), 6 * T * B),
            "lambda_returns": (4 * (inputs + T * B), 4 * T * B),
            "td_lambda_loss": (4 * (inputs + B), 7 * T * B),
            "td_lambda_err": (4 * (inputs + T * B), 5 * T * B)}


SCAN_ARGS = {"gae": (0.99, 0.97), "lambda_returns": (0.9, 0.8),
             "td_lambda_loss": (0.9, 0.8), "td_lambda_err": (0.9, 0.8)}


def scan_kernel_rows(rng, dev) -> dict:
    """The four scan kernels against their plain versions: at T=1024,
    B=4096 (timed, with bounds), at a ragged B (not a multiple of the
    32-column block) and at T=1; td_lambda_loss must be bitwise
    repeatable."""
    rows = {}
    for T, B in ((1024, 4096), (37, 1000), (1, 77)):
        value = torch.from_numpy(rng.standard_normal(
            (T + 1, B), dtype=np.float32)).to(dev)
        reward = torch.from_numpy(rng.standard_normal(
            (T, B), dtype=np.float32)).to(dev)
        bounds = scan_bounds(T, B)
        for name, scalars in SCAN_ARGS.items():
            wrapper = getattr(kernels, name)
            plain = getattr(kernels, name + "_plain")
            got = wrapper(value, reward, *scalars)
            again = wrapper(value, reward, *scalars)
            torch.cuda.synchronize()
            row = {"shape": f"T={T},B={B}"}
            if name == "td_lambda_loss":
                if not torch.equal(got, again):
                    raise AssertionError("td_lambda_loss: repeated runs "
                                         "differ")
                row["bitwise_repeatable"] = True
            row.update(compare(f"{name} T={T},B={B}", [got],
                               [plain(value, reward, *scalars)]))
            if T == 1024:
                row.update(kernel_ms(lambda: wrapper(value, reward,
                                                     *scalars), per_rep=10))
                row["plain_ms"] = cuda_ms(lambda: plain(value, reward,
                                                        *scalars), 3,
                                          warmup=1)
                row["bound_ms"], row["bound_by"] = bound_ms(*bounds[name])
            rows[f"{name} T={T}"] = row
    return rows


def linear_scan_bound(T, B, boundary: bool):
    """(bytes, ops) of the linear recurrence: a and b read once (and a (B,)
    boundary), y written once; one multiply-add per element."""
    return 4 * (3 * T * B + (B if boundary else 0)), 2 * T * B


def upgo_bounds(T, B):
    """(bytes, ops) of the two UPGO kernels: rhos, reward (and lp) (T, B)
    and value (T+1, B) read once, adv (T, B) or the (1, B) partials written
    once; 5 and 7 f32 operations per element (the decision's add and
    compare, the return's add, the advantage; the loss's multiply-add)."""
    return {"upgo_advantages": (4 * (4 * T * B + B), 5 * T * B),
            "upgo_loss": (4 * (4 * T * B + 2 * B), 7 * T * B)}


def full_plane_kernel_rows(rng, dev) -> dict:
    """Kernels 6, 11 and 12 against their plain versions at T=1024, B=4096
    (timed, with bounds), at a ragged B and at T=1; the linear recurrence in
    both directions with a zero, a scalar and a (B,) boundary; upgo_loss
    must be bitwise repeatable."""
    rows = {}
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                    ).to(dev)
    for T, B in ((1024, 4096), (37, 1000), (1, 77)):
        a, b = f(T, B), torch.from_numpy(rng.uniform(
            0.5, 1.0, (T, B)).astype(np.float32)).to(dev)
        boundaries = {"zero": None, "scalar": torch.tensor(0.7, device=dev),
                      "(B,)": f(B)}
        for reverse, direction in ((True, "reverse"), (False, "forward")):
            row = {"shape": f"T={T},B={B}", "vs_plain": {}}
            for kind, y in boundaries.items():
                got = kernels.linear_scan(a, b, y, reverse)
                torch.cuda.synchronize()
                want = kernels.linear_scan_plain(
                    a, b, None if y is None else y.expand(B), reverse)
                row["vs_plain"][kind] = compare(
                    f"linear_scan {direction} T={T} {kind}", [got], [want])
            row["max_abs_err"] = max(c["max_abs_err"]
                                     for c in row["vs_plain"].values())
            if T == 1024:
                row.update(kernel_ms(lambda: kernels.linear_scan(
                    a, b, None, reverse), per_rep=10))
                row["plain_ms"] = cuda_ms(lambda: kernels.linear_scan_plain(
                    a, b, None, reverse), 3, warmup=1)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    *linear_scan_bound(T, B, boundary=False))
            rows[f"linear_scan {direction} T={T}"] = row

        rhos = torch.exp(0.3 * f(T, B))
        lp, reward, value = -torch.abs(f(T, B)), f(T, B), f(T + 1, B)
        bounds = upgo_bounds(T, B)
        for name, args in (("upgo_advantages", (rhos, reward, value)),
                           ("upgo_loss", (rhos, lp, reward, value))):
            wrapper = getattr(kernels, name)
            plain = getattr(kernels, name + "_plain")
            got = wrapper(*args)
            again = wrapper(*args)
            torch.cuda.synchronize()
            row = {"shape": f"T={T},B={B}"}
            if name == "upgo_loss":
                if not torch.equal(got, again):
                    raise AssertionError("upgo_loss: repeated runs differ")
                row["bitwise_repeatable"] = True
            row.update(compare(f"{name} T={T},B={B}", [got], [plain(*args)]))
            if T == 1024:
                row.update(kernel_ms(lambda: wrapper(*args), per_rep=10))
                row["plain_ms"] = cuda_ms(lambda: plain(*args), 3, warmup=1)
                row["bound_ms"], row["bound_by"] = bound_ms(*bounds[name])
            rows[f"{name} T={T}"] = row
    return rows


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev) -> dict:
    rng = np.random.default_rng(SEED)
    clips = (0.99, 0.95, 1.0, 1.0, 1.0)
    rows = {"tolerance": {"rtol": RTOL, "atol": ATOL}}
    with torch.inference_mode():
        # LSTM layer at the forward's unroll and at the serving step.
        for S in (33, 1):
            B, H = 256, 512
            args = lstm_inputs(rng, S, B, H, dev)
            got = kernels.lstm_layer_fused(*args)
            torch.cuda.synchronize()
            want = kernels.lstm_layer_plain(*args)
            row = {"shape": f"S={S},B={B},H={H}",
                   **compare(f"lstm_layer S={S}", got, want)}
            row.update(kernel_ms(lambda: kernels.lstm_layer_fused(*args),
                                 per_rep=3))
            row["plain_ms"] = cuda_ms(lambda: kernels.lstm_layer_plain(*args),
                                      5)
            row["bound_ms"], row["bound_by"] = bound_ms(*lstm_bound(S, B, H))
            rows[f"lstm_layer_fused S={S}"] = row

        # The forward in stash mode, at the train step's unroll.
        S, B, H = 33, 256, 512
        args = lstm_inputs(rng, S, B, H, dev)
        got = kernels.lstm_layer_stash(*args)
        torch.cuda.synchronize()
        want = kernels.lstm_layer_stash_plain(*args)
        row = {"shape": f"S={S},B={B},H={H}",
               **compare("lstm_layer_stash", got, want)}
        row.update(kernel_ms(lambda: kernels.lstm_layer_stash(*args),
                             per_rep=3))
        row["plain_ms"] = cuda_ms(
            lambda: kernels.lstm_layer_stash_plain(*args), 5)
        nbytes, flops = lstm_bound(S, B, H)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes + 4 * S * B * H,
                                                    flops)
        rows["lstm_layer_stash S=33"] = row
        rows.update(bwd_kernel_rows(rng, dev))

        # V-trace kernels at the forward's (T, B) and the north-star shape.
        for T, B in ((32, 256), (1024, 4096)):
            is_w, lp, reward, value = vtrace_inputs(rng, T, B, dev)
            (lb, lo), (rb, ro) = vtrace_bounds(T, B)
            plain_reps = 3 if T > 100 else 7

            got = kernels.vtrace_losses(is_w, lp, reward, value, *clips)
            again = kernels.vtrace_losses(is_w, lp, reward, value, *clips)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError("vtrace_losses: repeated runs differ")
            want = kernels.vtrace_losses_plain(is_w, lp, reward, value,
                                               *clips)
            row = {"shape": f"T={T},B={B}", "bitwise_repeatable": True,
                   **compare(f"vtrace_losses T={T}", got, want)}
            row.update(kernel_ms(lambda: kernels.vtrace_losses(
                is_w, lp, reward, value, *clips), per_rep=10))
            row["plain_ms"] = cuda_ms(lambda: kernels.vtrace_losses_plain(
                is_w, lp, reward, value, *clips), plain_reps, warmup=1)
            row["bound_ms"], row["bound_by"] = bound_ms(lb, lo)
            rows[f"vtrace_losses T={T}"] = row

            got = kernels.vtrace_returns_adv(is_w, reward, value, *clips)
            torch.cuda.synchronize()
            want = kernels.vtrace_returns_adv_plain(is_w, reward, value,
                                                    *clips)
            row = {"shape": f"T={T},B={B}",
                   **compare(f"vtrace_returns_adv T={T}", got, want)}
            row.update(kernel_ms(lambda: kernels.vtrace_returns_adv(
                is_w, reward, value, *clips), per_rep=10))
            row["plain_ms"] = cuda_ms(lambda: kernels.vtrace_returns_adv_plain(
                is_w, reward, value, *clips), plain_reps, warmup=1)
            row["bound_ms"], row["bound_by"] = bound_ms(rb, ro)
            rows[f"vtrace_returns_adv T={T}"] = row
        rows.update(scan_kernel_rows(rng, dev))
        rows.update(full_plane_kernel_rows(rng, dev))
    return rows


def bwd_inputs(rng, S, B, H, dev):
    """The V2 backward's arguments: a stashed forward on the card and
    numpy-made cotangents."""
    gxp, wh, glnx, blnx, gln, bln, bias, h0, c0 = fwd = lstm_inputs(
        rng, S, B, H, dev)
    y, c_seq, _, _ = kernels.lstm_layer_stash(*fwd)
    dy, dhn, dcn = (torch.from_numpy(rng.standard_normal(shape,
                                                         dtype=np.float32))
                    .to(dev) for shape in ((S, B, H), (B, H), (B, H)))
    return (gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn,
            dcn)


BWD_TOLERANCE = {"tolerance": {"rtol": RTOL, "atol": ATOL,
                               "atol_rel_to_max": BWD_ATOL_REL}}


def bwd_kernel_rows(rng, dev) -> dict:
    """Both LSTM backward kernels against their plain versions at the train
    step's shapes, V2's repeatability, and the layer's autograd.Function
    against autograd through the plain forward."""
    rows = {}
    S, H = 33, 512
    for name, B in (("lstm_layer_bwd_v2", 256), ("lstm_layer_bwd_v1", 32)):
        args = bwd_inputs(rng, S, B, H, dev)
        if name.endswith("v1"):
            gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn, \
                dcn = args
            args = (*kernels.lstm_layer_bwd_v1_streams(
                gxp, y, c_seq, wh, glnx, blnx, bias, h0, c0), c_seq, dy, wh,
                gln, bln, dhn, dcn)
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        got = wrapper(*args)
        again = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        row = {"shape": f"S={S},B={B},H={H}", **BWD_TOLERANCE}
        if name.endswith("v2"):
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{name}: repeated runs differ")
            row["bitwise_repeatable"] = True
        row.update(compare(name, got, want, atol_rel=BWD_ATOL_REL))
        row.update(kernel_ms(lambda: wrapper(*args), per_rep=3))
        row["plain_ms"] = cuda_ms(lambda: plain(*args), 3, warmup=1)
        row["bound_ms"], row["bound_by"] = bound_ms(
            *lstm_bwd_bound(name[-2:], S, B, H))
        rows[f"{name} S={S}"] = row

    # The autograd.Function's 9 gradients at the train step's B=256 (V2),
    # against PyTorch's autograd through the plain forward, on the card.
    B = 256
    with torch.inference_mode(False), torch.enable_grad():
        fwd = [a.clone().requires_grad_() for a in
               lstm_inputs(rng, S, B, H, dev)]
        loss = lambda y, hn, cn: ((y * torch.cos(y)).sum() + (hn ** 2).sum()
                                  + torch.sin(cn).sum())
        got = torch.autograd.grad(loss(*kernels.lstm_layer_fused(*fwd)), fwd)
        want = torch.autograd.grad(loss(*kernels.lstm_layer_plain(*fwd)), fwd)
    rows["lstm_layer autograd.Function S=33"] = {
        "shape": f"S={S},B={B},H={H}",
        "vs": "autograd through the plain forward", **BWD_TOLERANCE,
        **compare("layer grads", got, want, atol_rel=BWD_ATOL_REL)}
    return rows


# ------------------------------------------------------------ phase 4 ----

OBS, HID, LAYERS, ACTIONS = 256, 512, 2, 64
T_FWD, B_FWD = 32, 256
T_VT, B_VT, N_VT = 1024, 4096, 32
SERVE_STEPS = 64


def model_arrays(rng):
    """Random weights at the JAX package's init scales, as numpy arrays."""
    H, L = HID, LAYERS
    g = 1.0 / np.sqrt(H)
    n = lambda s, *shape: s * rng.standard_normal(shape, dtype=np.float32)
    u = lambda *shape: rng.uniform(-g, g, shape).astype(np.float32)
    lstm = origin.LSTMParams(
        tuple(u(H, 4 * H) for _ in range(L)), tuple(u(H, 4 * H)
                                                    for _ in range(L)),
        u(L, 4 * H), np.ones((L, 4 * H), np.float32),
        np.zeros((L, 4 * H), np.float32), np.ones((L, 4 * H), np.float32),
        np.zeros((L, 4 * H), np.float32))
    return models.ActorCriticArrays(
        n(1 / np.sqrt(OBS), OBS, H), np.zeros(H, np.float32), lstm,
        n(g, H, ACTIONS), np.zeros(ACTIONS, np.float32), n(g, H, 1),
        np.zeros(1, np.float32))


def vtrace_batch(rng, T, B, N, with_target: bool):
    """numpy-made V-trace inputs.  The target logits and values are made too
    unless the model's forward provides them."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    arrays = {"behaviour": f(T, B, N), "action": rng.integers(0, N, (T, B)),
              "reward": f(T, B), "weight": rng.uniform(0, 2, (T, B))
              .astype(np.float32)}
    if with_target:
        arrays["target"], arrays["value"] = f(T, B, N), f(T + 1, B)
    return arrays


def to_dev(arrays, dev):
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in arrays.items()}


SLICE_KERNELS = ("lstm_layer_fused", "vtrace_losses", "vtrace_returns_adv")


def check_launched(path, launches, names) -> None:
    never = [n for n in names if launches[n] < 1]
    if never:
        raise AssertionError(f"{path}: kernels of the path never launched: "
                             f"{never} ({launches})")


def run_vtrace(x, target, value):
    unit = ops.vtrace_error(ops.vtrace_data(
        target, x["behaviour"], x["action"], value, x["reward"], None))
    weighted = ops.vtrace_error(ops.vtrace_data(
        target, x["behaviour"], x["action"], value, x["reward"],
        x["weight"]))
    return tuple(unit) + tuple(weighted)


def run_slice(params, obs, serve_obs, fwd_x, big_x, dev, serve_gen):
    """The main path: forward, its V-trace losses, the serving loop and the
    north-star V-trace call.  Returns every output."""
    logits, value, state = models.actor_critic_forward(params, obs)
    fwd_losses = run_vtrace(fwd_x, logits[:T_FWD], value)
    serve_state = (torch.zeros(LAYERS, B_FWD, HID, device=dev),
                   torch.zeros(LAYERS, B_FWD, HID, device=dev))
    serve_logits = []
    for t in range(SERVE_STEPS):
        action, step_logits, step_value, serve_state = models.actor_step(
            params, serve_obs[t], serve_state, serve_gen)
        serve_logits.append(step_logits)
    big_losses = run_vtrace(big_x, big_x["target"], big_x["value"])
    return {"logits": logits, "value": value, "h": state[0], "c": state[1],
            "fwd_losses": torch.stack(fwd_losses),
            "serve_logits": torch.stack(serve_logits),
            "serve_value": step_value, "serve_h": serve_state[0],
            "serve_c": serve_state[1], "serve_action": action,
            "big_losses": torch.stack(big_losses)}


def slice_inputs(dev):
    """Weights and inputs of the main path, made with numpy from the seed:
    (numpy weights, params on dev, obs, serving obs, numpy forward-loss
    batch, numpy north-star batch, the two batches on dev)."""
    rng = np.random.default_rng(SEED + 1)
    arrays = model_arrays(rng)
    params = models.from_jax_params(arrays, device=dev)
    obs_np = rng.standard_normal((T_FWD + 1, B_FWD, OBS), dtype=np.float32)
    serve_np = rng.standard_normal((SERVE_STEPS, B_FWD, OBS),
                                   dtype=np.float32)
    fwd_np = vtrace_batch(rng, T_FWD, B_FWD, ACTIONS, with_target=False)
    big_np = vtrace_batch(rng, T_VT, B_VT, N_VT, with_target=True)
    obs, serve_obs = (torch.from_numpy(a).to(dev) for a in (obs_np, serve_np))
    fwd_x, big_x = to_dev(fwd_np, dev), to_dev(big_np, dev)
    torch.cuda.synchronize()
    return arrays, params, obs, serve_obs, fwd_np, big_np, fwd_x, big_x


def timed_calls(params, obs, serve_obs, big_x, gen, dev):
    """The three end-to-end calls that are timed: one forward over the
    unroll, SERVE_STEPS serving steps with the state carried, one V-trace
    call at the north-star shape."""
    state = (torch.zeros(LAYERS, B_FWD, HID, device=dev),) * 2

    def serve():
        s = state
        for t in range(SERVE_STEPS):
            s = models.actor_step(params, serve_obs[t], s, gen)[3]

    return {
        "forward_S33_B256": lambda: models.actor_critic_forward(params, obs),
        f"actor_step_x{SERVE_STEPS}_B256": serve,
        "vtrace_T1024_B4096_N32": lambda: ops.vtrace_error(ops.vtrace_data(
            big_x["target"], big_x["behaviour"], big_x["action"],
            big_x["value"], big_x["reward"], None)),
    }


def phase_slice(dev) -> dict:
    arrays, params, obs, serve_obs, fwd_np, big_np, fwd_x, big_x = \
        slice_inputs(dev)

    with torch.inference_mode():
        kernels.reset_launch_counts()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        out = run_slice(params, obs, serve_obs, fwd_x, big_x, dev, gen)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    check_launched("slice", launches, SLICE_KERNELS)

    shapes = {"logits": (T_FWD + 1, B_FWD, ACTIONS),
              "value": (T_FWD + 1, B_FWD), "h": (LAYERS, B_FWD, HID),
              "c": (LAYERS, B_FWD, HID), "fwd_losses": (6,),
              "serve_logits": (SERVE_STEPS, B_FWD, ACTIONS),
              "serve_value": (B_FWD,), "serve_h": (LAYERS, B_FWD, HID),
              "serve_c": (LAYERS, B_FWD, HID), "serve_action": (B_FWD,),
              "big_losses": (6,)}
    for k, want in shapes.items():
        if tuple(out[k].shape) != want:
            raise AssertionError(f"{k}: shape {tuple(out[k].shape)}, "
                                 f"want {want}")
        if out[k].is_floating_point() and not torch.isfinite(out[k]).all():
            raise AssertionError(f"{k}: non-finite values")
    act = out["serve_action"]
    if int(act.min()) < 0 or int(act.max()) >= ACTIONS:
        raise AssertionError("actor_step: action out of range")

    # The same calls through the plain versions on the CPU, same inputs.
    cpu = torch.device("cpu")
    with torch.inference_mode():
        ref = run_slice(models.from_jax_params(arrays, device=cpu),
                        obs.cpu(), serve_obs.cpu(), to_dev(fwd_np, cpu),
                        to_dev(big_np, cpu), cpu,
                        torch.Generator().manual_seed(SEED))
    checked = {k: compare(f"slice {k}", [out[k]], [ref[k]])
               for k in shapes if k != "serve_action"}

    # Times, after the counted run: host clock around synchronized work.
    with torch.inference_mode():
        fwd, serve, vtrace = timed_calls(params, obs, serve_obs, big_x, gen,
                                         dev).values()
        fwd_ms = host_ms(fwd, 7)
        serve_ms = host_ms(serve, 3) / SERVE_STEPS
        vt_ms = host_ms(vtrace, 7)
    return {"launches": launches, "tolerance": {"rtol": RTOL, "atol": ATOL},
            "check_vs_cpu": checked,
            "losses_fwd": [float(x) for x in out["fwd_losses"]],
            "losses_vtrace_T1024": [float(x) for x in out["big_losses"]],
            "ms_per_forward_S33_B256": fwd_ms,
            "ms_per_actor_step_B256": serve_ms,
            "ms_per_vtrace_T1024_B4096_N32": vt_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


# ------------------------------------------------------------ phase 5 ----

T_TR = 32
TRAIN_LEGS = ((256, "lstm_layer_bwd_v2"), (32, "lstm_layer_bwd_v1"))
TRAIN_TIMED_STEPS = 7
# Card against CPU for the train step's gradients: each entry is a sum over
# the (T+1)*B rows of the unroll (and, for the LSTM weights, over the steps
# of the reverse loop), taken in another order on the two sides, so its
# rounding scales with the tensor's magnitude, not the entry's: atol is
# GRAD_ATOL_REL times the tensor's largest entry, rtol is RTOL.
GRAD_ATOL_REL = 1e-4


def train_batch(rng, B):
    """numpy-made TrainBatch fields: obs (T+1, B, OBS), actions, rewards,
    behaviour logits."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return (f(T_TR + 1, B, OBS), rng.integers(0, ACTIONS, (T_TR, B)),
            f(T_TR, B), f(T_TR, B, ACTIONS))


def train_setup(arrays, batch_np, dev):
    """Params on dev, their Adam(lr=1e-3) train step, and the batch."""
    params = models.from_jax_params(arrays, device=dev)
    step = models.make_train_step(
        models.ActorCriticConfig(OBS, HID, LAYERS, ACTIONS),
        torch.optim.Adam(params.parameters(), lr=1e-3))
    batch = models.TrainBatch(*(torch.from_numpy(np.asarray(a)).to(dev)
                                for a in batch_np))
    return params, step, batch


def phase_train(dev) -> dict:
    rng = np.random.default_rng(SEED + 2)
    arrays = model_arrays(rng)
    cpu = torch.device("cpu")
    out = {"tolerance": {"metrics": {"rtol": RTOL, "atol": ATOL},
                         "grads": {"rtol": RTOL, "atol": 0.0,
                                   "atol_rel_to_max": GRAD_ATOL_REL}}}
    for B, bwd in TRAIN_LEGS:
        batch_np = train_batch(rng, B)
        params, step, batch = train_setup(arrays, batch_np, dev)
        kernels.reset_launch_counts()
        metrics = step(params, batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        check_launched(f"train B={B}", launches, ("lstm_layer_fused", bwd,
                                                  "vtrace_losses",
                                                  "vtrace_returns_adv"))
        ref_params, ref_step, ref_batch = train_setup(arrays, batch_np, cpu)
        ref = ref_step(ref_params, ref_batch)
        leg = {"launches": launches,
               "metrics": {k: float(v) for k, v in metrics.items()},
               "metrics_vs_cpu": compare(f"train B={B} metrics",
                                         list(metrics.values()),
                                         list(ref.values()))}
        grads = {}
        for (name, p), (_, q) in zip(params.named_parameters(),
                                     ref_params.named_parameters()):
            grads[name] = {"max_abs_grad": float(q.grad.abs().max()),
                           **compare(f"train B={B} grad {name}", [p.grad],
                                     [q.grad], atol=0.0,
                                     atol_rel=GRAD_ATOL_REL)}
        leg["grads_vs_cpu"] = grads
        if B == TRAIN_LEGS[0][0]:
            leg[f"ms_per_train_step_T{T_TR}_B{B}"] = host_ms(
                lambda: step(params, batch), TRAIN_TIMED_STEPS)
            leg["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out[f"B={B}"] = leg
    return out


# ------------------------------------------------------------ phase 6 ----

T_OP, B_OP = 1024, 4096             # GAE and TD(lambda): bench.py:550, :676
B_PPO, N_PPO = 4096, 128            # PPO: bench.py:441
# The PPO trainer of examples/ppo_training.py with actions=128 and rollouts
# of T=16, B=256: each epoch's loss runs on a flat (4096, 128) batch.
PPO_CFG = {"obs_dim": 32, "hidden": 64, "actions": 128, "T": 16, "B": 256}
PPO_ITERS, PPO_EPOCHS, PPO_LR = 2, 4, 3e-4
ONPOLICY_KERNELS = ("gae", "lambda_returns", "td_lambda_loss",
                    "td_lambda_err")


def onpolicy_arrays(rng):
    """numpy-made inputs of the op calls: GAE/TD(lambda) value, reward and
    a (B,) weight; the PPO batch."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    logit_new = f(B_PPO, N_PPO)
    return {"value": f(T_OP + 1, B_OP), "reward": f(T_OP, B_OP),
            "weight": rng.uniform(0, 2, B_OP).astype(np.float32),
            "logit_new": logit_new,
            "logit_old": logit_new + 0.3 * f(B_PPO, N_PPO),
            "action": rng.integers(0, N_PPO, B_PPO),
            "value_old": f(B_PPO), "value_new": f(B_PPO), "adv": f(B_PPO),
            "return_": f(B_PPO)}


def run_onpolicy_ops(x) -> dict:
    """ops.gae, ops.td_lambda_error (unit weight, forward and the gradient
    in value; a (B,) weight) and both PPO losses (forward and the gradients
    in logit_new and value_new) at the JAX bench's shapes."""
    out = {"gae": ops.gae(ops.gae_data(x["value"], x["reward"]), 0.99,
                          0.97)}
    value = x["value"].clone().requires_grad_()
    loss = ops.td_lambda_error(ops.td_lambda_data(value, x["reward"], None),
                               0.9, 0.8)
    loss.backward()
    out["td_lambda"], out["td_lambda_dvalue"] = loss.detach(), value.grad
    out["td_lambda_weighted"] = ops.td_lambda_error(ops.td_lambda_data(
        x["value"], x["reward"], x["weight"]), 0.9, 0.8)
    lp_old = ops.logp(x["logit_old"], x["action"])
    for name, fn, data in (
            ("ppo_fast", ops.ppo_error_with_logp_old, ops.ppo_fast_data),
            ("ppo", ops.ppo_error, ops.ppo_data)):
        logit = x["logit_new"].clone().requires_grad_()
        vnew = x["value_new"].clone().requires_grad_()
        old = lp_old if name == "ppo_fast" else x["logit_old"]
        (pol, vl, ent), (kl, frac) = fn(data(
            logit, old, x["action"], vnew, x["value_old"], x["adv"],
            x["return_"], None), 0.2, True, None)
        (pol + 0.5 * vl - 0.01 * ent).backward()
        out[name] = torch.stack([pol, vl, ent, kl, frac]).detach()
        out[name + "_dlogit"], out[name + "_dvalue"] = logit.grad, vnew.grad
    return out


def ppo_params(rng, obs_dim, hidden, actions, **_):
    """The example's MLP (examples/ppo_training.py:33-43) as numpy arrays."""
    n = lambda fan_in, *s: (rng.standard_normal(s) / np.sqrt(fan_in)
                            ).astype(np.float32)
    return {"w1": n(obs_dim, obs_dim, hidden),
            "b1": np.zeros(hidden, np.float32),
            "policy_w": n(hidden, hidden, actions),
            "policy_b": np.zeros(actions, np.float32),
            "value_w": n(hidden, hidden, 1),
            "value_b": np.zeros(1, np.float32)}


def ppo_rollouts(rng, iters, obs_dim, actions, T, B, **_):
    """Synthetic rollouts, one per iteration: observations (T+1, B, obs),
    rewards (T, B) and the Gumbel noise (T, B, actions) that samples the
    policy's actions (argmax of logits + noise)."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return [(f(T + 1, B, obs_dim), 0.1 * f(T, B),
             rng.gumbel(size=(T, B, actions)).astype(np.float32))
            for _ in range(iters)]


def ppo_forward(p, obs):
    h = torch.tanh(obs @ p["w1"] + p["b1"])
    return h @ p["policy_w"] + p["policy_b"], (h @ p["value_w"]
                                               + p["value_b"])[..., 0]


def ppo_collect(p, obs, reward, gumbel):
    """Roll the policy over the observations and compute the GAE
    advantages and the old policy's log-prob, once per batch
    (examples/ppo_training.py:67-82)."""
    T = reward.shape[0]
    with torch.no_grad():
        logits, value = ppo_forward(p, obs)
        action = torch.argmax(logits[:T] + gumbel, dim=-1)
        adv = ops.gae(ops.gae_data(value, reward), gamma=0.99, lambda_=0.95)
        return {"obs": obs[:T], "action": action,
                "logp_old": ops.logp(logits[:T], action),
                "value_old": value[:T], "adv": adv,
                "return_": adv + value[:T]}


def ppo_loss(p, batch):
    """One epoch's loss on the flat (T*B, ...) batch
    (examples/ppo_training.py:84-98): (total, metrics)."""
    flat = lambda x: x.reshape((-1,) + x.shape[2:])
    logits, value = ppo_forward(p, batch["obs"])
    (pol, vl, ent), (kl, frac) = ops.ppo_error_with_logp_old(
        ops.ppo_fast_data(flat(logits), flat(batch["logp_old"]),
                          flat(batch["action"]), flat(value),
                          flat(batch["value_old"]), flat(batch["adv"]),
                          flat(batch["return_"]), None),
        clip_ratio=0.2, use_value_clip=True, dual_clip=None)
    total = pol + 0.5 * vl - 0.01 * ent
    return total, {"total": total, "policy": pol, "value": vl,
                   "entropy": ent, "approx_kl": kl, "clipfrac": frac}


def ppo_iteration(p, opt, rollout, epochs):
    """Collect, then `epochs` Adam steps on the batch: each epoch's metrics
    (detached) and gradients."""
    batch = ppo_collect(p, *rollout)
    log = []
    for _ in range(epochs):
        total, metrics = ppo_loss(p, batch)
        opt.zero_grad()
        total.backward()
        log.append(({k: v.detach() for k, v in metrics.items()},
                    {k: v.grad.clone() for k, v in p.items()}))
        opt.step()
    return log


def ppo_setup(arrays, rollouts_np, dev):
    """Parameters (copies: Adam updates them in place), their Adam and the
    rollouts, on dev."""
    p = {k: torch.tensor(v, device=dev, requires_grad=True)
         for k, v in arrays.items()}
    rollouts = [tuple(torch.from_numpy(a).to(dev) for a in r)
                for r in rollouts_np]
    return p, torch.optim.Adam(p.values(), lr=PPO_LR), rollouts


def ppo_train(arrays, rollouts_np, dev):
    """PPO_ITERS iterations of PPO_EPOCHS epochs: the per-epoch log, the
    final parameters."""
    p, opt, rollouts = ppo_setup(arrays, rollouts_np, dev)
    log = [entry for r in rollouts
           for entry in ppo_iteration(p, opt, r, PPO_EPOCHS)]
    return log, p


def check_adam_params(name, got, want, grads, lr, steps) -> dict:
    """Updated parameters, card against CPU: within 1e-6 where |g| > 1e-4
    at every step, else within 2 * lr per step (Adam's update is lr *
    g / (|g| + eps) at first, so an entry whose gradient lies at the noise
    floor may move either way on the two sides)."""
    out = {}
    for k in want:
        g, w = got[k].detach().cpu(), want[k].detach()
        big = torch.stack([gr[k].abs() for gr in grads]).amin(0) > 1e-4
        err_big = float((g - w)[big].abs().max()) if big.any() else 0.0
        err_small = float((g - w)[~big].abs().max()) if (~big).any() else 0.0
        if err_big > 1e-6 or err_small > 2 * lr * steps + 1e-6:
            raise AssertionError(f"{name} param {k}: {err_big} where "
                                 f"|g| > 1e-4, {err_small} elsewhere")
        out[k] = {"max_abs_err_big_g": err_big,
                  "max_abs_err_small_g": err_small,
                  "n_small_g": int((~big).sum())}
    return out


def phase_onpolicy(dev) -> dict:
    rng = np.random.default_rng(SEED + 4)
    x_np = onpolicy_arrays(rng)
    ppo_np = ppo_params(rng, **PPO_CFG)
    rollouts_np = ppo_rollouts(rng, PPO_ITERS, **PPO_CFG)
    x = to_dev(x_np, dev)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    out = run_onpolicy_ops(x)
    log, p = ppo_train(ppo_np, rollouts_np, dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launched("onpolicy", launches, ONPOLICY_KERNELS)

    cpu = torch.device("cpu")
    ref = run_onpolicy_ops(to_dev(x_np, cpu))
    ref_log, ref_p = ppo_train(ppo_np, rollouts_np, cpu)
    result = {"launches": launches,
              "tolerance": {"rtol": RTOL, "atol": ATOL},
              "check_vs_cpu": {k: compare(f"onpolicy {k}", [out[k]],
                                          [ref[k]]) for k in ref}}
    for i, ((m, g), (rm, rg)) in enumerate(zip(log, ref_log)):
        result["check_vs_cpu"][f"ppo epoch {i}"] = compare(
            f"ppo epoch {i} metrics", list(m.values()), list(rm.values()))
        for k in rg:
            compare(f"ppo epoch {i} grad {k}", [g[k]], [rg[k]], atol=0.0,
                    atol_rel=GRAD_ATOL_REL)
    result["ppo_params_vs_cpu"] = check_adam_params(
        "ppo", p, ref_p, [g for _, g in ref_log], PPO_LR, len(ref_log))
    result["ppo_epochs"] = [{k: float(v) for k, v in m.items()}
                            for m, _ in log]
    result["td_lambda"] = float(out["td_lambda"])

    timed = onpolicy_timed_calls(x, ppo_np, rollouts_np, dev)
    result["ms_per_gae_T1024_B4096"] = host_ms(timed["gae_T1024_B4096"], 7)
    result["ms_per_td_lambda_fwd_bwd_T1024_B4096"] = host_ms(
        timed["td_lambda_fwd_bwd_T1024_B4096"], 7)
    result["ms_per_ppo_iteration_T16_B256_N128"] = host_ms(
        timed["ppo_iteration_T16_B256_N128"], 5)
    return result


def onpolicy_timed_calls(x, ppo_np, rollouts_np, dev):
    """The three end-to-end calls that are timed: one ops.gae call, one
    td_lambda_error forward + backward, one PPO iteration (collect and
    PPO_EPOCHS Adam steps)."""
    value = x["value"].clone().requires_grad_()
    p, opt, rollouts = ppo_setup(ppo_np, rollouts_np, dev)

    def td_lambda():
        value.grad = None
        ops.td_lambda_error(ops.td_lambda_data(value, x["reward"], None),
                            0.9, 0.8).backward()

    return {
        "gae_T1024_B4096": lambda: ops.gae(ops.gae_data(
            x["value"], x["reward"]), 0.99, 0.97),
        "td_lambda_fwd_bwd_T1024_B4096": td_lambda,
        "ppo_iteration_T16_B256_N128": lambda: ppo_iteration(
            p, opt, rollouts[0], PPO_EPOCHS),
    }


# ------------------------------------------------------------ phase 7 ----

T_SC, B_SC = 1024, 4096                 # the scan entry points: bench.py:550
T_UG, B_UG, N_UG = 128, 512, 128        # ops.upgo_loss: bench.py:651
SC_B, SC_M, SC_N, SC_HW = 256, 256, 256, (16, 16)   # scatter: bench.py:609
# The train step of examples/alphastar_policy_training.py with its own
# configuration (main's defaults, :61-63), Adam(lr=3e-4), synthetic batches.
AS_CFG = {"T": 16, "B": 8, "M": 32, "De": 16, "N": 32, "H": 8, "W": 8,
          "F": 64, "Hc": 128, "A": 8, "Hs": 64}
AS_SELECTIONS, AS_LR, AS_STEPS = 6, 3e-4, 3
UPGO_KERNELS = ("linear_scan", "upgo_loss", "upgo_advantages",
                "lstm_layer_fused", "lstm_layer_bwd_v1", "vtrace_losses",
                "vtrace_returns_adv")


def upgo_arrays(rng):
    """numpy-made inputs of the op calls: the scan entry points' a, b, y,
    value, reward and (T, B) gamma and lambda planes; the UPGO loss's
    logits, rhos, actions, rewards and values; the scatter's entities and
    locations."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    return {"a": f(T_SC, B_SC), "b": u(0.5, 1.0, T_SC, B_SC),
            "b_row": u(0.5, 1.0, T_SC, 1), "y": f(B_SC),
            "value": f(T_SC + 1, B_SC), "reward": f(T_SC, B_SC),
            "gammas": u(0.9, 1.0, T_SC, B_SC),
            "lambdas": u(0.0, 1.0, T_SC, B_SC),
            "logits": f(T_UG, B_UG, N_UG),
            "rhos": np.exp(0.1 * f(T_UG, B_UG)),
            "action": rng.integers(0, N_UG, (T_UG, B_UG)),
            "rewards": f(T_UG, B_UG), "values": f(T_UG + 1, B_UG),
            "sc_x": f(SC_B, SC_M, SC_N),
            "sc_loc": np.stack([rng.integers(0, SC_HW[0], (SC_B, SC_M)),
                                rng.integers(0, SC_HW[1], (SC_B, SC_M))],
                               axis=-1)}


def upgo_loss_fwd_bwd(x):
    """ops.upgo_loss at the bench's T=128, B=512, N=128 with its gradient
    in the logits: (loss, dlogits)."""
    logits = x["logits"].clone().requires_grad_()
    loss = ops.upgo_loss(logits, x["rhos"], x["action"], x["rewards"],
                         x["values"])
    loss.backward()
    return loss.detach(), logits.grad


def scatter_fwd_bwd(x, mode):
    """network.scatter_connection and the gradient of sum(out^2) in x, as
    the bench's scatter stage: (out, dx)."""
    xs = x["sc_x"].clone().requires_grad_()
    out = network.scatter_connection(xs, SC_HW, x["sc_loc"], mode)
    (out ** 2).sum().backward()
    return out.detach(), xs.grad


def run_upgo_ops(x) -> dict:
    """The scan entry points under "auto" (the linear recurrence both ways,
    with a (B,) boundary and a row-constant b; the lambda-returns with (T, B)
    gamma and lambda planes; the UPGO returns), the UPGO loss with its
    gradient and both scatter modes with theirs."""
    out = {"linear_reverse": ops.linear_recurrence_reverse(
               x["a"], x["b"], x["y"]),
           "linear_forward": ops.linear_recurrence_forward(
               x["a"], x["b_row"], 0.5),
           "lambda_returns": ops.generalized_lambda_returns(
               x["value"], x["reward"], x["gammas"], x["lambdas"]),
           "upgo_returns": ops.upgo_returns(x["reward"], x["value"])}
    out["upgo_loss"], out["upgo_dlogits"] = upgo_loss_fwd_bwd(x)
    for mode in ("add", "cover"):
        out[f"scatter_{mode}"], out[f"scatter_{mode}_dx"] = scatter_fwd_bwd(
            x, mode)
    return out


def alphastar_arrays(rng, De, N, H, W, F, Hc, A, Hs, **_):
    """The example's Params (init_params, :46-58) at its init scales, as
    numpy arrays: normal / sqrt(fan_in) weights, a uniform(-g, g) LN-LSTM
    layer with LN at identity, the selection head of
    init_entity_selection."""
    n = lambda fan, *s: (rng.standard_normal(s) / np.sqrt(fan)
                         ).astype(np.float32)
    g = 1.0 / np.sqrt(Hc)
    u = lambda *s: rng.uniform(-g, g, s).astype(np.float32)
    ln = lambda v: np.full((1, 4 * Hc), v, np.float32)
    core = origin.LSTMParams((u(N + F, 4 * Hc),), (u(Hc, 4 * Hc),),
                             u(1, 4 * Hc), ln(1.0), ln(0.0), ln(1.0), ln(0.0))
    sel = models.EntitySelectionArrays(
        n(N, N, 4 * Hs), n(Hs, Hs, 4 * Hs), np.zeros(4 * Hs, np.float32),
        n(Hs, Hs, N))
    return models.AlphaStarArrays(
        n(De, De, N), np.zeros(N, np.float32), n(N * H * W, N * H * W, F),
        core, n(Hc, Hc, A), n(Hc, Hc), n(Hc, Hc, N), sel)


def alphastar_batches(rng, steps, T, B, M, De, H, W, A, **_):
    """Synthetic trajectory batches, one per step, as the example's
    train_step draws them (:72-80)."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return [{"ent_feats": f(T + 1, B, M, De),
             "locations": np.stack([rng.integers(0, H, (T + 1, B, M)),
                                    rng.integers(0, W, (T + 1, B, M))],
                                   axis=-1),
             "actions": rng.integers(0, A, (T, B)),
             "behaviour": f(T, B, A), "rewards": 0.1 * f(T, B),
             "entity_num": rng.integers(M // 2, M + 1, (B,))}
            for _ in range(steps)]


def alphastar_loss(p, x, max_selections):
    """The example's loss_fn (:82-129) on the port: entity encoder, the
    scatter connection (add), the LN-LSTM core, V-trace and UPGO on the
    action-type head, the greedy selected-units head with its REINFORCE
    term.  Returns (total, the example's metrics)."""
    T1, B, M, N = x["ent_feats"].shape[:3] + (p.ent_w.shape[1],)
    H, W = x["H"], x["W"]
    emb = torch.tanh(x["ent_feats"] @ p.ent_w + p.ent_b)          # (T+1,B,M,N)
    spatial = network.scatter_connection(
        emb.reshape(T1 * B, M, N), (H, W),
        x["locations"].reshape(T1 * B, M, 2), "add")
    spatial = spatial.reshape(T1, B, N * H * W) @ p.spatial_w
    core_in = torch.cat([emb.mean(dim=2), torch.tanh(spatial)], dim=-1)
    y, _ = network.lstm_fused(p.core.params(), core_in, None, "LN")
    value = y @ p.val_w                                            # (T+1, B)
    logits = y[:-1] @ p.act_w                                      # (T, B, A)

    actions, rewards = x["actions"], x["rewards"]
    vt = ops.vtrace_error(ops.vtrace_data(logits, x["behaviour"], actions,
                                          value, rewards, None))
    logp_b = ops.logp(x["behaviour"], actions).detach()
    rhos = torch.clamp(torch.exp(ops.logp(logits, actions).detach() - logp_b),
                       max=1.0)
    upgo = ops.upgo_loss(logits, rhos, actions, rewards, value)

    ae0 = torch.tanh(y[-1] @ p.ae_w)                               # (B, N)
    Hs = p.sel.w_hh.shape[0]
    zeros = torch.zeros((B, Hs), device=y.device)
    entity_num = x["entity_num"]
    selected, sel_logits, _, _ = models.select_entities(
        p.sel, emb[-1], torch.ones((B, M), dtype=torch.bool,
                                   device=y.device),
        entity_num, ae0, (zeros, zeros), max_selections)
    is_end = (selected == entity_num[None, :]).to(torch.int32)
    after_end = (torch.cumsum(is_end, dim=0) - is_end) > 0
    sel_logp = torch.where(after_end, torch.zeros((), device=y.device),
                           ops.logp(sel_logits, selected))         # (S, B)
    adv = (rewards.sum(dim=0) - value[0]).detach()
    sel_loss = -torch.mean(adv * sel_logp.sum(dim=0))

    total = (vt.policy_loss + 0.5 * vt.value_loss - 0.01 * vt.entropy_loss
             + 0.2 * upgo + 0.1 * sel_loss)
    return total, {"total": total, "pg": vt.policy_loss,
                   "value": vt.value_loss, "upgo": upgo, "select": sel_loss}


def alphastar_setup(arrays, batches_np, dev, H, W, **_):
    """Params on dev (copies: Adam updates them in place), their Adam and
    the batches, on dev."""
    p = models.from_jax_params(arrays, device=dev)
    batches = [{**to_dev(b, dev), "H": H, "W": W} for b in batches_np]
    return p, torch.optim.Adam(p.parameters(), lr=AS_LR), batches


def alphastar_step(p, opt, batch):
    """One train step: loss, backward, Adam.  Returns the metrics
    (detached) and the gradients by parameter name."""
    opt.zero_grad()
    total, metrics = alphastar_loss(p, batch, AS_SELECTIONS)
    total.backward()
    grads = {k: v.grad.clone() for k, v in p.named_parameters()}
    opt.step()
    return {k: v.detach() for k, v in metrics.items()}, grads


def _cpu_copy(state: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def phase_upgo(dev) -> dict:
    rng = np.random.default_rng(SEED + 6)
    x_np = upgo_arrays(rng)
    as_np = alphastar_arrays(rng, **AS_CFG)
    batches_np = alphastar_batches(rng, AS_STEPS, **AS_CFG)
    x = to_dev(x_np, dev)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    out = run_upgo_ops(x)
    p, opt, batches = alphastar_setup(as_np, batches_np, dev, **AS_CFG)
    log, starts = [], []
    for batch in batches:
        starts.append((_cpu_copy(p.state_dict()),
                       copy.deepcopy(opt.state_dict())))
        log.append(alphastar_step(p, opt, batch))
        starts[-1] = (*starts[-1], _cpu_copy(p.state_dict()))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launched("upgo", launches, UPGO_KERNELS)

    cpu = torch.device("cpu")
    ref = run_upgo_ops(to_dev(x_np, cpu))
    result = {"launches": launches,
              "tolerance": {"rtol": RTOL, "atol": ATOL,
                            "grads_atol_rel_to_max": GRAD_ATOL_REL},
              "check_vs_cpu": {k: compare(f"upgo {k}", [out[k]], [ref[k]])
                               for k in ref},
              "alphastar_params_vs_cpu": {}}
    # Each CPU step starts from the card's parameters and Adam state before
    # that step.  Two independent runs would part after the first step:
    # Adam moves an entry whose gradient lies at the noise floor by +-lr,
    # in either direction on the two sides, and later steps amplify that.
    # So every step is held as a first step is: metrics, gradients, and the
    # updated parameters by check_adam_params.
    ref_p, ref_opt, ref_batches = alphastar_setup(as_np, batches_np, cpu,
                                                  **AS_CFG)
    for i, ((m, g), (p_before, opt_before, p_after)) in enumerate(
            zip(log, starts)):
        ref_p.load_state_dict(p_before)
        ref_opt.load_state_dict(opt_before)
        rm, rg = alphastar_step(ref_p, ref_opt, ref_batches[i])
        result["check_vs_cpu"][f"alphastar step {i}"] = compare(
            f"alphastar step {i} metrics", list(m.values()),
            list(rm.values()))
        for k in rg:
            compare(f"alphastar step {i} grad {k}", [g[k]], [rg[k]],
                    atol=0.0, atol_rel=GRAD_ATOL_REL)
        result["alphastar_params_vs_cpu"][f"step {i}"] = check_adam_params(
            f"alphastar step {i}", p_after, dict(ref_p.named_parameters()),
            [rg], AS_LR, 1)
    result["alphastar_steps"] = [{k: float(v) for k, v in m.items()}
                                 for m, _ in log]
    result["upgo_loss"] = float(out["upgo_loss"])

    timed = upgo_timed_calls(x, as_np, batches_np, dev)
    result["ms_per_upgo_loss_fwd_bwd_T128_B512_N128"] = host_ms(
        timed["upgo_loss_fwd_bwd_T128_B512_N128"], 7)
    result["ms_per_scatter_add_grad_B256_M256"] = host_ms(
        timed["scatter_add_grad_B256_M256"], 7)
    result["ms_per_alphastar_train_step_T16_B8"] = host_ms(
        timed["alphastar_train_step_T16_B8"], 7)
    return result


def upgo_timed_calls(x, as_np, batches_np, dev):
    """The three end-to-end calls that are timed: one ops.upgo_loss forward
    + backward, one scatter add + gradient, one AlphaStar train step."""
    p, opt, batches = alphastar_setup(as_np, batches_np[:1], dev, **AS_CFG)
    return {
        "upgo_loss_fwd_bwd_T128_B512_N128": lambda: upgo_loss_fwd_bwd(x),
        "scatter_add_grad_B256_M256": lambda: scatter_fwd_bwd(x, "add"),
        "alphastar_train_step_T16_B8": lambda: alphastar_step(p, opt,
                                                              batches[0]),
    }


# ------------------------------------------------------------ phase 8 ----

def profile_one(fn) -> dict:
    """torch.profiler over one call of fn after a warm-up call: device busy
    time (the sum of kernel and copy times on the one stream), the wall time
    of the window (profiler overhead included) and the top kernels by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "top": [{"kernel": k[:120], "count": c, "ms": t / 1e3}
                    for k, c, t in rows[:10]]}


def phase_profile(dev) -> dict:
    """profile_one over each timed call of the slice, the train step at
    B=256, the three on-policy calls, the UPGO loss and the AlphaStar train
    step."""
    _, params, obs, serve_obs, _, _, _, big_x = slice_inputs(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    with torch.inference_mode():
        for name, fn in timed_calls(params, obs, serve_obs, big_x, gen,
                                    dev).items():
            out[name] = profile_one(fn)
    rng = np.random.default_rng(SEED + 3)
    B = TRAIN_LEGS[0][0]
    params, step, batch = train_setup(model_arrays(rng), train_batch(rng, B),
                                      dev)
    out[f"train_step_T{T_TR}_B{B}"] = profile_one(lambda: step(params, batch))
    rng = np.random.default_rng(SEED + 5)
    x = to_dev(onpolicy_arrays(rng), dev)
    for name, fn in onpolicy_timed_calls(
            x, ppo_params(rng, **PPO_CFG),
            ppo_rollouts(rng, 1, **PPO_CFG), dev).items():
        out[name] = profile_one(fn)
    rng = np.random.default_rng(SEED + 7)
    x = to_dev(upgo_arrays(rng), dev)
    as_np = alphastar_arrays(rng, **AS_CFG)
    timed = upgo_timed_calls(x, as_np, alphastar_batches(rng, 1, **AS_CFG),
                             dev)
    for name in ("upgo_loss_fwd_bwd_T128_B512_N128",
                 "alphastar_train_step_T16_B8"):
        out[name] = profile_one(timed[name])
    return out


KERNELS = (
    ("lstm_layer_fused", "di_hpc_tpu_torch/csrc/lstm_layer.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:115", "lstm_layer_fused S=33"),
    ("lstm_layer_bwd_v2", "di_hpc_tpu_torch/csrc/lstm_layer_bwd.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:389", "lstm_layer_bwd_v2 S=33"),
    ("lstm_layer_bwd_v1", "di_hpc_tpu_torch/csrc/lstm_layer_bwd.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:276", "lstm_layer_bwd_v1 S=33"),
    ("vtrace_losses", "di_hpc_tpu_torch/csrc/vtrace.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:558", "vtrace_losses T=1024"),
    ("vtrace_returns_adv", "di_hpc_tpu_torch/csrc/vtrace.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:472", "vtrace_returns_adv T=1024"),
    ("gae", "di_hpc_tpu_torch/csrc/rl_scans.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:92", "gae T=1024"),
    ("lambda_returns", "di_hpc_tpu_torch/csrc/rl_scans.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:165", "lambda_returns T=1024"),
    ("td_lambda_loss", "di_hpc_tpu_torch/csrc/rl_scans.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:213", "td_lambda_loss T=1024"),
    ("td_lambda_err", "di_hpc_tpu_torch/csrc/rl_scans.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:236", "td_lambda_err T=1024"),
    ("linear_scan", "di_hpc_tpu_torch/csrc/linear_scan.cu",
     "di_hpc_tpu/pallas_kernels/linear_scan.py:124",
     "linear_scan reverse T=1024"),
    ("upgo_advantages", "di_hpc_tpu_torch/csrc/rl_scans.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:333", "upgo_advantages T=1024"),
    ("upgo_loss", "di_hpc_tpu_torch/csrc/rl_scans.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:391", "upgo_loss T=1024"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on a card and has no CPU mode", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    results = {}
    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernels", lambda: phase_kernels(dev)),
                     ("slice", lambda: phase_slice(dev)),
                     ("train", lambda: phase_train(dev)),
                     ("onpolicy", lambda: phase_onpolicy(dev)),
                     ("upgo", lambda: phase_upgo(dev)),
                     ("profile", lambda: phase_profile(dev))):
        start = time.perf_counter()
        try:
            results[name] = fn()
        except Exception as e:      # report the phase, then fail the run
            emit({"phase": name, "ok": False,
                  "error": f"{type(e).__name__}: {e}"})
            raise
        emit({"phase": name, "ok": True,
              "seconds": time.perf_counter() - start, **results[name]})

    rows = results["kernels"]
    # Launches on each counted path run: the slice, the train legs, the
    # on-policy path, the UPGO/AlphaStar path.
    by_path = {"slice": results["slice"]["launches"],
               **{f"train {leg}": results["train"][leg]["launches"]
                  for leg in results["train"] if leg.startswith("B=")},
               "onpolicy": results["onpolicy"]["launches"],
               "upgo": results["upgo"]["launches"]}
    check_launched("all paths", {name: sum(c[name] for c in by_path.values())
                                 for name, *_ in KERNELS},
                   [name for name, *_ in KERNELS])
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": sum(counts[name] for counts in by_path.values()),
         "launches_by_path": {path: counts[name]
                              for path, counts in by_path.items()},
         "max_abs_err": rows[key]["max_abs_err"], "ms": rows[key]["ms"],
         "ms_l2_warm": rows[key]["ms_l2_warm"],
         "plain_ms": rows[key]["plain_ms"], "bound_ms": rows[key]["bound_ms"],
         "bound_by": rows[key]["bound_by"], "library_ms": None,
         "at": rows[key]["shape"]}
        for name, source, replaces, key in KERNELS]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
