#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (di_hpc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # no arguments; needs one CUDA card
    python3 chip_smoke.py --digests    # only the LSTM and scan kernels'
                                       # output digests and ptxas lines
    python3 chip_smoke.py --profile    # only phase 14 (profile)
    python3 chip_smoke.py --parallel   # only phases 1, 2, 12 and 13; on as
                                       # many cards as the worlds have
                                       # ranks, one rank per card over NCCL
    python3 chip_smoke.py --parallel-worker DIR RANK WORLD
                                       # one rank of phase 12, which
                                       # spawns them
    python3 chip_smoke.py --multichip-worker DIR RANK WORLD
                                       # one rank of phase 13's full-width
                                       # world, which spawns them

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
                calls.  The LSTM forward (kernel 1) runs at the forward's
                and the serving step's shapes (S=33 and S=1, B=256, H=512)
                and in stash mode, also at S=33 with B=64 and the ragged
                B=200, at S=1 with B=8, and at H=510 (H % 4 != 0: the 8-row
                kernel); every forward row must be bitwise repeatable and
                prints its launch (route, cluster size, rows per group,
                cudaOccupancyMaxActiveClusters, ptxas' registers and
                spills); the S=33, B=256 row times 24 against 16 rows per
                cluster, the S=1, B=8 row 8 against 24.  The LSTM backward
                kernels run at the train step's shapes (V2 at S=33, B=256,
                V1 at S=33, B=32, H=512), V2 also at B=64 and at the ragged
                B=200, V1 also at the ragged B=40 and at the AlphaStar
                core's S=17, B=8, H=128; every backward row must be bitwise
                repeatable and prints its launch as kernel 1's do; V1's
                B=32 and B=8 rows time its clusters of 8 against 16 CTAs
                in turns;
                the float32 LSTM rows are bounded at the 3xTF32 tensor-core
                rate; the layer's autograd.Function (stash forward,
                backward kernels) is held against autograd through the
                plain forward.  The V-trace kernels (vtrace_losses,
                vtrace_returns_adv) run at the forward's T=32, B=256, the
                north-star T=1024, B=4096, the B=32 train leg's T=32 and
                the AlphaStar step's T=16, B=8; each row is bitwise
                repeatable and prints its launch (columns and chunks per
                CTA, super-tiles, grid, ptxas' registers and spills); the
                T=1024 rows time the chosen tiling against 32 columns x
                8 chunks in turns.  The categorical head's kernels
                (categorical_fwd with and without the entropy,
                categorical_bwd) run at the V-trace cell's T=1024, B=4096,
                N=128 in float32 and (with the entropy) in bf16, with dense
                N(0, 1) incoming gradients, each bitwise repeatable and the
                float32 backward bitwise the plain version's, with ptxas'
                lines and the plain version's time.  The scan kernels
                (gae, lambda_returns, td_lambda_loss, td_lambda_err,
                linear_scan both ways with a
                zero, a scalar and a (B,) boundary, upgo_advantages,
                upgo_loss) run at T=1024, B=4096, at a ragged B and at T=1;
                the four row-constant ones and both UPGO kernels must be
                bitwise repeatable.  All seven scan kernels (linear_scan,
                td_lambda_loss, td_lambda_err, gae, lambda_returns,
                upgo_loss, upgo_advantages) are chunked and print their
                launch (columns and chunks per CTA,
                super-tiles, ptxas' registers and spills), time the chosen
                tiling against 16x16 and 32x8 in turns at T=1024 (upgo_loss
                also without its wrapper's work), and are held against their
                plain versions at every shape of the card tests (T = 1, 7,
                8, 9, 65, 1000, 1024 x B = 1, 5, 33, 4100; both directions
                with a zero, a scalar and a large (B,) boundary; the loss,
                the error and the returns planes at gamma*lambda = 0,
                lambda = 1 and gamma = 1, GAE at gamma*lambda = 0, lambda =
                1 and gamma = lambda = 1, the UPGO loss and advantage plane
                on normal inputs and on integer-valued ones, where they must
                equal the plain version; bitwise repeatable), GAE also at
                the PPO trainer's T=16, B=256, and GAE, the error and
                returns planes and both UPGO kernels at every tiling of the
                card tests.
                The bf16 instantiations of the three LSTM kernels run at the
                f32 rows' shapes (the forward's rows but H=510, the
                backward's rows),
                each against its plain bf16 version on the card, bounded at
                the bf16 tensor-core peak and at bf16 bytes.
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
                Both legs must route every LSTM layer to the kernels
                (`network.lstm_fused.routes`).  Then `network.lstm_fused`
                with a gradient at H=30 (S=8, B=4, 2 layers), which the
                backward kernels cannot take: every layer must take the
                recurrent path, launch no kernel, and agree with the CPU.
  6. bf16    -- the mixed-precision path, counts set to 0 just before it and
                read just after: `make_train_step(compute_dtype=
                torch.bfloat16)` at the flagship's full width, T=32, B=256
                (the bf16 V2 backward) and B=32 (the bf16 V1), a bf16
                `actor_critic_forward` over (33, 256), 16 bf16 `actor_step`s
                at B=256 with the state carried, and `network.lstm_fused(
                remat=True)` forward + backward at S=33, B=256 in bf16.  Every
                output finite, every bf16 kernel launched; the train steps'
                metrics and gradients against the same bf16 step on the CPU
                and against the float32 step (JAX's bf16 bounds: 0.15 on
                outputs, 0.25 x max on gradients); the forward and serving
                outputs against the CPU; the remat path in float32 against
                the CPU (its bf16 run is chaotic and only reported); then
                ms per bf16 train step at each B, per bf16 forward and per
                bf16 serving step.
  7. onpolicy -- the on-policy learner path, counts set to 0 just before it
                and read just after: `ops.gae` (T=1024, B=4096),
                `ops.td_lambda_error` (unit weight with the gradient in
                value, and a (B,) weight), `ops.ppo_error_with_logp_old`
                and `ops.ppo_error` with their gradients (B=4096, N=128),
                then the PPO trainer of di_hpc_tpu_torch.examples.
                ppo_training (obs 32, hidden 64, 128 actions, rollouts
                T=16, B=256; 2 iterations of GAE, logp_old and 4 Adam
                epochs).  Every output, each
                epoch's metrics and gradients and the final parameters
                against the same calls on the CPU; then ms per GAE call, per
                TD(lambda) forward + backward and per PPO iteration.
  8. upgo    -- the scan entry points, UPGO and the AlphaStar path, counts
                set to 0 just before it and read just after:
                `ops.linear_recurrence_{reverse,forward}` ("auto") and
                `ops.generalized_lambda_returns` with (T, B) gamma and lambda
                planes at T=1024, B=4096, `ops.upgo_returns` at that shape,
                `ops.upgo_loss` with its gradient at T=128, B=512, N=128,
                `network.scatter_connection` (add and cover) with its
                gradient at B=M=N=256, 16x16, then 3 steps of the train step
                of di_hpc_tpu_torch.examples.alphastar_policy_training (the
                JAX example's configuration:
                T=16, B=8, 32 entities, a 128-wide LN-LSTM core, 6 greedy
                selections; Adam(lr=3e-4); synthetic batches).  Every output,
                each step's metrics and gradients and the final parameters
                against the same calls on the CPU; then ms per UPGO loss
                forward + backward, per scatter add + gradient and per
                AlphaStar train step.
  9. nstep   -- the batch-bound TD family and the R2D2 learner, counts set
                to 0 just before it and read just after: forward and the
                gradient in q (or dist) of `ops.q_nstep_td_error` and
                `ops.q_nstep_td_error_with_rescale` (B=64, N=64, nstep 5),
                `ops.dist_nstep_td_error` (B=128, N=128, 51 atoms, nstep
                10; bitwise repeatable), `ops.qrdqn_nstep_td_error` (tau=64,
                B=4096, N=64) and `ops.iqn_nstep_td_error` (tau=33,
                tau'=34, B=64, N=8, nstep 10, kappa 0.9), then 3 steps of
                the train step of di_hpc_tpu_torch.examples.r2d2_training
                (the JAX example's configuration: S=20, burn-in 4, B=32,
                obs 16, a 128-wide
                LN-LSTM, 8 actions, nstep 3; Adam(lr=1e-3); synthetic
                replay samples), whose LSTM takes kernel 1 and kernel 5
                (V1) on every layer.  Every output, gradient, step's loss,
                priorities and updated parameters against the same calls
                on the CPU; then ms per op call and per R2D2 step.
 10. replay -- the replay learners and the five examples' main(), counts
                set to 0 just before each part and read just after: 3
                steps each of the C51 trainer (di_hpc_tpu_torch.examples.
                c51_training: B=128, obs 32, hidden 64, 8 actions, 51
                atoms, nstep 3) and the QR-DQN and IQN trainers
                (quantile_dqn_training: B=64, obs 24, hidden 64, 8 actions,
                tau = tau' = 32, 64 cosine features, nstep 3, kappa 1) in
                the JAX examples' configurations, each step against the
                same step on the CPU started from the card's parameters and
                Adam state before it and given the card's next action (held
                against the CPU's own argmax up to near ties): the loss and
                per-sample TD errors at REPLAY_RTOL/REPLAY_ATOL, every
                gradient, the updated parameters (check_adam_params); host
                ms per step.  These paths run no kernel, and the phase
                fails if one launches.  Then the main() of c51_training,
                quantile_dqn_training, ppo_training,
                alphastar_policy_training and r2d2_training once each at
                its defaults (the JAX examples'), their printout and
                seconds kept, their parameters finite; these launches are
                path `examples` (kernels 1, 5, 2, 3, 7, 11, 12), every LSTM
                layer on the kernels.
 11. hostdata -- the host data plane and its two examples.  Ragged padding
                at the JAX bench's configuration (bench.py:890-903: B=64
                float32 items, 1D 32-128, 2D 48-80 x 32-64, 3D 24-32 x 24-32
                x 32-40), each ungrouped, grouped by the oracle DP and by
                sampled pivots (group 4): the padded batches, masks and
                shapes on the card equal the CPU's bit for bit from numpy
                inputs and from CUDA inputs (packed on the card), and
                UnPadding gives back every input; host-clock medians of the
                bucketing + pack, the transfer, the whole call and the
                oracle's.  `stack_trajectories` and `TrajectoryBuffer.
                sample_batch` (FIFO and replay) at the actor-learner's batch
                (T=16, B=32, with a ragged float32 and int32 field), the
                card's batch equal to the CPU's; the same trajectories with
                float64 fields and int64 actions arrive float32 and int32,
                as JAX's transfer gives them, and `ops.vtrace_error` on
                them launches kernels 2 and 3.  Then, counts set to 0 just
                before and read just after: `entry()`'s forward, 3 steps of
                the episodic A2C of examples/episodic_a2c_padding.py (its
                configuration: 48 episodes of length 8-64, group 3; kernels
                8 and 6 once per bucket) and 6 learner steps of the
                actor-learner of examples/impala_actor_learner.py (obs 16,
                H 64, 1 layer, T=16, B=32; kernels 1, 2, 3 and 5), each held
                against the CPU: the forward, every episodic step's loss,
                gradients and Adam update, the learner's step 0 (its batch
                and parameters recorded), finite losses.  A checkpoint round
                trip of the card's parameters and Adam state, bitwise; ms per
                learner and episodic step; `utils.bench_fn` and
                `utils.roofline` on `ops.gae` at T=1024, B=4096 beside phase
                kernels' GAE row.
 12. parallel -- the parallel layer (di_hpc_tpu_torch.parallel) in a gloo
                world of 4 processes on the one card, each on cuda:0,
                spawned with a deadline (PAR_TIMEOUT_S) that kills the
                world: `linear_recurrence_{reverse,forward}_sharded` on the
                meshes {data: 4} (time sharded over it), {time: 4} and
                {time: 2, data: 2} (batch over data), `gae_`, `lambda_returns_`,
                `td_lambda_error_` (unit and (B,) weight), `upgo_loss_` and
                `vtrace_error_time_sharded` (with the policy loss's gradient
                in the target logits) on {time: 2, data: 2}, all at T=1024,
                B=4096 (N=32), and `data_parallel` of `ops.vtrace_error`
                (forward and backward, kernels 2 and 3 on each rank's
                batch shard), `ops.ppo_error` and `ops.q_nstep_td_error`
                (B=4096, N=10, nstep 3) on {data: 4}.  Each rank runs the
                unsharded ops on the card, then every sharded call with
                the counts set to 0 just before and read just after (kernel
                6 for each local time chunk), holds each against the
                unsharded op at RTOL/ATOL, each gradient block by block
                over its mesh's shards at RTOL and PAR_GRAD_REL of the
                block's max|want| (every block nonzero), and prints its
                launches, checks,
                digests and host-clock medians on one line; every rank's
                results must equal rank 0's bit for bit.  The host clocks
                are four processes sharing one card, with every collective
                staged through the host: not a scaling figure.
 13. multichip -- the data x model sharded train step
                (models.make_sharded_train_step) on the one card, three
                parts: `entry.dryrun_multichip(4)`, a gloo world of 4 rank
                processes on a {data: 2, model: 2} mesh running the JAX
                dryrun's twelve legs (the sharded train step in f32 and
                bf16 at its tiny setup, 8 rows per rank: kernels 1 and 5;
                the time-sharded scan and four losses on {time: 2, data:
                2}: kernel 6; C51, QR-DQN, IQN, the scatter connection and
                grouped padding sharded over the batch), each against the
                unsharded op on the card, twice, every rank's results rank
                0's bits; then a world of the same shape running MC_STEPS
                sharded train steps at the flagship's full width (obs 256,
                H 512, 2 layers, 64 actions, T=32, global B=256: 128 rows
                per rank, kernel 4) in f32 and in bf16, each step's metrics,
                gathered gradients and gathered parameters against the
                unsharded step on the card from the same parameters and
                Adam state (f32 at RTOL and GRAD_ATOL_REL of each leaf's
                max|want|; bf16 at the bf16 train step's bounds; the
                parameters by entry.sharded_train_steps' rule), every rank's
                results rank 0's bits, then rank 0's host-clock medians of
                MC_REPS sharded and unsharded steps; then
                `examples.impala_training.main` for IMPALA_STEPS steps in
                f32 and in bf16 in a world of one (B=64, H=128: kernel 4),
                finite losses.  Each part's sharded calls are counted per
                rank, and every rank must launch its part's kernels
                (MC_PART_KERNELS); every sharded LSTM layer must take the
                kernels (`lstm_fused.routes`).  Under `--parallel` on 4
                cards each world takes NCCL, one rank per card.
 14. profile -- torch.profiler over one more run of each of the timed calls
                (forward, serving loop, V-trace, train step, the three
                on-policy calls, the UPGO loss, the AlphaStar train step and
                the bf16 train step), of the f32 and bf16 train steps at
                B=32, of the weighted `ops.td_lambda_error` at T=1024,
                B=4096, of phase upgo's four scan entry points, of phase
                nstep's five TD ops and R2D2 step, of phase replay's C51,
                QR-DQN and IQN steps and of phase hostdata's episodic step
                and learner step: device busy time, idle
                share of the window and the top kernels by device time.

Then one `{"kernels": [...]}` line, the nvidia-smi line, and, last, the
contract line `{"ok": true, "device": {...}}`.  With `--digests` it prints
only the sha256 of the LSTM kernels' outputs at the rows' shapes (the
backward's inputs from the plain forward) and their ptxas lines, and of the
scan kernels' (2, 3, 6-12) outputs at T=1024, B=4096 and at the ragged
T=1000, B=4100: run in two checkouts, they show whether a change left those
kernels bitwise the same.
With `--profile` it prints only phase 14's line, which runs in an older
checkout too.  Any
failure prints its phase
with `"ok": false` and exits 1; no card (or no port beside this script)
exits non-zero before any result.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Without the rest of the repository beside this script, this import fails
# and the run ends before it prints anything.
from di_hpc_tpu_torch import (  # noqa: E402
    kernels, models, network, ops, origin)
from di_hpc_tpu_torch.kernels import _build  # noqa: E402

# H100 SXM data sheet peaks (dense, 700 W): HBM bytes/s, float32 FLOP/s
# outside the tensor cores, and the bf16 tensor-core rate.  A bf16 row is
# bounded at the bf16 rate, the least time the card needs for bf16 work.
# The float32 rows of the LSTM kernels (1, 4, 5) are bounded at the 3xTF32
# rate, a third of the TF32 tensor-core peak: products with float32
# accuracy on the tensor cores take three TF32 passes (big*big + big*small
# + small*big), and that is the least time the card needs for them (the
# V2 kernel runs its products so).  The scan kernels' few operations stay
# at the FMA rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32X3_FLOP_PER_S = 495e12 / 3
BF16_FLOP_PER_S = 989e12

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

# A bf16 kernel against its plain bf16 version on the card: the same f32
# values up to summation order, rounded to bf16 at the same points, so a
# value near a rounding boundary can round the other way (one bf16 ulp,
# 2^-8 relative) and the recurrence carries that on.  The bound is
# BF16_REL times the output's largest |entry| plus twice the spread between
# the plain version on the CPU and on the card (the same flips, no kernel).
BF16_REL = 1e-2

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


def sha256(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                      .cpu().numpy().tobytes())
    return digest.hexdigest()


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

def lstm_inputs(rng, S, B, H, dev, dtype=torch.float32):
    G = 4 * H
    g = 1.0 / np.sqrt(H)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)
    arrays = (n(S, B, G), rng.uniform(-g, g, (H, G)).astype(np.float32),
              1 + 0.1 * n(G), 0.1 * n(G), 1 + 0.1 * n(G), 0.1 * n(G),
              0.1 * n(G), 0.5 * n(B, H), 0.5 * n(B, H))
    return [torch.from_numpy(a).to(dev, dtype) for a in arrays]


def lstm_bound(S, B, H, item=4):
    """(bytes, ops) of the forward with `item`-byte streams."""
    G = 4 * H
    nbytes = item * (S * B * G + H * G + 5 * G + 2 * B * H   # in
                     + S * B * H + 2 * B * H)                # out
    flops = 2 * S * B * H * G                                # h @ Wh
    return nbytes, flops


def lstm_bwd_bound(variant, S, B, H, item=4):
    """(bytes, ops) of the V2 or V1 backward function with `item`-byte
    streams: each input read once (V2 reads y and c_seq at steps 0..S-2
    only), each output written once; V2's parameter partials (one
    (3, 4H) row per group of rows) and V1's gh_pre are float32 for either
    stream type.  V2 does two products with
    Wh per step (the gh_pre recompute and dh = dg_pre @ Wh^T), V1 one.
    LayerNorm and gate math, a few percent of the operations, are not
    counted."""
    G = 4 * H
    if variant == "v2":
        groups = kernels.v2_launch_shape(B, H, item)["groups"]
        return (item * (S * B * G + 2 * (S - 1) * B * H + S * B * H + H * G
                        + 5 * G + 4 * B * H                          # in
                        + 2 * S * B * G + 2 * B * H)                 # out
                + 4 * groups * 3 * G,
                4 * S * B * H * G)
    return (item * (S * B * G + 3 * S * B * H + H * G + 2 * G + 2 * B * H
                    + 2 * S * B * G + 2 * B * H) + 4 * S * B * G,
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


# The V-trace kernels' rows: the forward's (T, B) and the north-star shape,
# then the B=32 train leg's and the AlphaStar step's (from their own seed,
# so that the earlier rows keep their inputs).
VTRACE_ROWS = ((32, 256), (1024, 4096), (32, 32), (16, 8))
VTRACE_CLIPS = (0.99, 0.95, 1.0, 1.0, 1.0)
# The tiling timed against the chosen one at the north-star shape.
VTRACE_OTHER = ({"cols": 32, "chunks": 8},)
# Both V-trace instantiations: label -> (kernel, tag of the mangled name).
VTRACE_INSTANCES = {"losses": ("vtrace_chunked_kernel", "ILb1E"),
                    "returns_adv": ("vtrace_chunked_kernel", "ILb0E")}


# The tilings timed against the chosen one at T=1024, B=4096 for kernels 6
# and 9.
SCAN_OTHER_TILINGS = ({"cols": 16, "chunks": 16}, {"cols": 32, "chunks": 8})


def chunked_launch_info(shape_fn, T, B, instances) -> dict:
    """A kernel's launch at (T, B) on this card (shape_fn: one of the
    kernels chunked over T's launch-shape functions) and ptxas' register and
    spill lines of its instantiations (`instances`: label -> (kernel, tag
    of the mangled name))."""
    log = _build.library().build_log
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {**shape_fn(T, B, sms),
            "ptxas": {label: ptxas_of(log, kernel, tag)
                      for label, (kernel, tag) in instances.items()}}


def chunked_candidates(launch, shape_fn, T, B,
                       others=SCAN_OTHER_TILINGS) -> dict:
    """The cold time of launch(cols=..., chunks=...) at the chosen tiling
    and at each of `others`, in turns (chosen, the others, the others again
    in reverse, chosen), each with its launch shape."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = shape_fn(T, B, sms)
    chosen = {"cols": shape["cols"], "chunks": shape["chunks"]}
    others = [t for t in others if t != chosen]
    out = {}
    for tiling in (chosen, *others, *reversed(others), chosen):
        ms = cold_ms(lambda: launch(**tiling))
        out.setdefault(f"{tiling['cols']}x{tiling['chunks']}", {
            **shape_fn(T, B, sms, **tiling), "ms": []})["ms"].append(ms)
    return out


def vtrace_kernel_rows(rng, dev) -> dict:
    """Both V-trace kernels against their plain versions at VTRACE_ROWS'
    shapes, each bitwise repeatable, with its launch, times and bound; at
    T=1024 the chosen tiling against VTRACE_OTHER."""
    rows = {}
    extra = np.random.default_rng(SEED + 17)
    clips = VTRACE_CLIPS
    for T, B in VTRACE_ROWS:
        is_w, lp, reward, value = vtrace_inputs(
            rng if (T, B) in VTRACE_ROWS[:2] else extra, T, B, dev)
        bounds = vtrace_bounds(T, B)
        plain_reps = 3 if T > 100 else 7
        for name, args in (("vtrace_losses", (is_w, lp, reward, value)),
                           ("vtrace_returns_adv", (is_w, reward, value))):
            wrapper = getattr(kernels, name)
            plain = getattr(kernels, name + "_plain")
            got = wrapper(*args, *clips)
            again = wrapper(*args, *clips)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{name} T={T} B={B}: repeated runs "
                                     f"differ")
            row = {"shape": f"T={T},B={B}", "bitwise_repeatable": True,
                   "launch": chunked_launch_info(
                       kernels.vtrace_launch_shape, T, B, VTRACE_INSTANCES),
                   **compare(f"{name} T={T},B={B}", got,
                             plain(*args, *clips))}
            row.update(kernel_ms(lambda: wrapper(*args, *clips),
                                 per_rep=10))
            row["plain_ms"] = cuda_ms(lambda: plain(*args, *clips),
                                      plain_reps, warmup=1)
            row["bound_ms"], row["bound_by"] = bound_ms(
                *bounds[name == "vtrace_returns_adv"])
            if T == 1024:
                launch = getattr(kernels.rl_scans, f"_{name}_cuda")
                row["candidates"] = chunked_candidates(
                    lambda **tiling: launch(*args, *clips, **tiling),
                    kernels.vtrace_launch_shape, T, B, VTRACE_OTHER)
            key = f"{name} T={T}" + ("" if (T, B) in VTRACE_ROWS[:2]
                                     else f" B={B}")
            rows[key] = row
    return rows


# The categorical head's rows: the V-trace cell's shape (T 1024, B 4096,
# N 128), whose float32 logits plane is 2.147 GB, in float32 and bf16.
CATEGORICAL_ROW = (1024, 4096, 128)
_BF16_TAG = "13__nv_bfloat16"
# The instantiations that run there: label -> (kernel, tag of the mangled
# name: the logits' type, 4 logits a lane, with or without the entropy, one
# chunk a row).
CATEGORICAL_INSTANCES = {
    "categorical_fwd": ("categorical_fwd_kernel", "IfLi4ELb1ELb1E"),
    "categorical_fwd logp": ("categorical_fwd_kernel", "IfLi4ELb0ELb1E"),
    "categorical_bwd": ("categorical_bwd_kernel", "IfLi4ELb1ELb1E"),
    "categorical_fwd bf16": ("categorical_fwd_kernel",
                             f"I{_BF16_TAG}Li4ELb1ELb1E"),
    "categorical_bwd bf16": ("categorical_bwd_kernel",
                             f"I{_BF16_TAG}Li4ELb1ELb1E")}


def categorical_bounds(T, B, N):
    """(bytes, ops) of the head's kernels: the logits read once, the int32
    actions and the per-row statistics read or written once (the
    forward's logp, lse and entropy; the backward's lse, entropy and both
    dense incoming gradients), the backward's gradient written once (2
    bytes a logit in bf16, else 4); 7, 5 and 9 f32 operations per logit
    (clamp, max, subtract, exp, add and the entropy's multiply-add; without
    it the last two go; the backward's subtract, exp, floor, add,
    multiply, add, multiply, compare and subtract)."""
    plane, rows = T * B * N, T * B
    fwd = lambda item: (item * plane + 4 * 4 * rows, 7 * plane)
    bwd = lambda item: (2 * item * plane + 5 * 4 * rows, 9 * plane)
    return {"categorical_fwd": fwd(4),
            "categorical_fwd logp": (4 * plane + 3 * 4 * rows, 5 * plane),
            "categorical_bwd": bwd(4),
            "categorical_fwd bf16": fwd(2), "categorical_bwd bf16": bwd(2)}


def categorical_kernel_rows(dev) -> dict:
    """The categorical head's kernels against their plain versions at
    CATEGORICAL_ROW (logits drawn on the card from their own seed, int32
    actions, and a dense N(0, 1) plane each for the incoming logp and
    entropy gradients, so the backward's entropy term is as large as its
    one-hot term): the float32 forward with and without the entropy and
    the backward with it, then the bf16 forward and backward on the same
    logits rounded to bf16.  Each row is bitwise repeatable and holds the
    kernel against the plain version at RTOL/ATOL (bf16 gradients at 1e-2
    relative, one bf16 rounding); the float32 backward must equal the plain
    version bit for bit; each row gives its ptxas lines, cold and L2-warm
    times, the plain version's time and the bytes bound."""
    T, B, N = CATEGORICAL_ROW
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    x = torch.randn((T, B, N), generator=gen, device=dev)
    a = torch.randint(0, N, (T, B), generator=gen, device=dev,
                      dtype=torch.int32)
    glp = torch.randn((T, B), generator=gen, device=dev)
    gent = torch.randn((T, B), generator=gen, device=dev)
    bounds = categorical_bounds(T, B, N)
    log = _build.library().build_log
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x if dtype == torch.float32 else x.to(dtype)
        _, ent, lse = kernels.categorical_fwd(xd, a, True)
        calls = {
            "categorical_fwd": (
                lambda: kernels.categorical_fwd(xd, a, True),
                lambda: kernels.categorical_fwd_plain(xd, a, True)),
            "categorical_fwd logp": (
                lambda: kernels.categorical_fwd(xd, a, False),
                lambda: kernels.categorical_fwd_plain(xd, a, False)),
            "categorical_bwd": (
                lambda: [kernels.categorical_bwd(xd, a, lse, ent, glp,
                                                  gent)],
                lambda: [kernels.categorical_bwd_plain(xd, a, lse, ent, glp,
                                                       gent)])}
        if dtype == torch.bfloat16:
            del calls["categorical_fwd logp"]
        for key, (run, plain) in calls.items():
            if dtype == torch.bfloat16:
                key += " bf16"
            got = [t for t in run() if t is not None]
            again = [t for t in run() if t is not None]
            torch.cuda.synchronize()
            if not all(torch.equal(g, h) for g, h in zip(got, again)):
                raise AssertionError(f"{key}: repeated runs differ")
            want = [t for t in plain() if t is not None]
            equal = all(torch.equal(g, h) for g, h in zip(got, want))
            if key == "categorical_bwd" and not equal:
                raise AssertionError(f"{key}: the gradient differs from the "
                                     f"plain version's")
            tol = {"rtol": 1e-2, "atol": 1e-5} if key == \
                "categorical_bwd bf16" else {}
            kernel, tag = CATEGORICAL_INSTANCES[key]
            row = {"shape": f"T={T},B={B},N={N}",
                   "bitwise_repeatable": True, "equal_to_plain": equal,
                   "ptxas": ptxas_of(log, kernel, tag),
                   **compare(f"{key} T={T}", got, want, **tol)}
            del got, again, want
            row.update(kernel_ms(run, per_rep=3))
            row["plain_ms"] = cuda_ms(plain, 3, warmup=1)
            row["bound_ms"], row["bound_by"] = bound_ms(*bounds[key])
            rows[f"{key} T={T}"] = row
        del xd, ent, lse
    return rows


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


# The chunked row-constant scan kernels: name -> (name of the launch-shape
# function in `kernels`, instantiations for chunked_launch_info).  Names,
# so that the script still imports in an older checkout (--digests,
# --profile).
CHUNKED_SCANS = {
    "gae": ("gae_launch_shape", {"gae": ("gae_chunked_kernel", "")}),
    "lambda_returns": ("lambda_returns_launch_shape",
                       {"returns": ("td_lambda_chunked_kernel",
                                    "TdEpilogueE2")}),
    "td_lambda_loss": ("td_lambda_launch_shape",
                       {"loss": ("td_lambda_chunked_kernel",
                                 "TdEpilogueE0")}),
    "td_lambda_err": ("td_lambda_err_launch_shape",
                      {"error": ("td_lambda_chunked_kernel",
                                 "TdEpilogueE1")})}


def scan_kernel_rows(rng, dev) -> dict:
    """The four scan kernels against their plain versions: at T=1024,
    B=4096 (timed, with bounds), at a ragged B (not a multiple of the
    32-column block) and at T=1, each bitwise repeatable; the chunked ones
    (CHUNKED_SCANS) print their launch (tiling, ptxas), their T=1024 rows
    also timing the chosen tiling against SCAN_OTHER_TILINGS."""
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
            if not torch.equal(got, again):
                raise AssertionError(f"{name} T={T} B={B}: repeated runs "
                                     f"differ")
            row = {"shape": f"T={T},B={B}", "bitwise_repeatable": True,
                   **compare(f"{name} T={T},B={B}", [got],
                             [plain(value, reward, *scalars)])}
            if name in CHUNKED_SCANS:
                shape_fn = getattr(kernels, CHUNKED_SCANS[name][0])
                row["launch"] = chunked_launch_info(shape_fn, T, B,
                                                    CHUNKED_SCANS[name][1])
            if T == 1024:
                row.update(kernel_ms(lambda: wrapper(value, reward,
                                                     *scalars), per_rep=10))
                row["plain_ms"] = cuda_ms(lambda: plain(value, reward,
                                                        *scalars), 3,
                                          warmup=1)
                row["bound_ms"], row["bound_by"] = bound_ms(*bounds[name])
                if name in CHUNKED_SCANS:
                    launch = getattr(kernels.rl_scans, f"_{name}_cuda")
                    row["candidates"] = chunked_candidates(
                        lambda **tiling: launch(value, reward, *scalars,
                                                **tiling),
                        shape_fn, T, B)
                if name == "gae":
                    row["kernel_alone_ms"] = gae_kernel_alone_ms(
                        value, reward, *scalars)
            rows[f"{name} T={T}"] = row
    return rows


def gae_kernel_alone_ms(value, reward, gamma, lambda_) -> float:
    """The GAE kernel's cold time without its wrapper's work: the
    denominators (gae_denominators' seven small kernels) are made once,
    outside the timed call."""
    scans = kernels.rl_scans
    denom = scans._gae_denominators(reward.shape[0], lambda_, reward)
    adv = torch.empty_like(reward)
    tiling = scans._tiling(kernels.gae_launch_shape, reward, None, None)
    return cold_ms(lambda: scans._launch(
        "gae", "gae_f32", (value, reward, denom, adv), gamma, lambda_,
        *tiling))


# The card tests' shapes for the chunked scan kernels
# (tests/test_torch_gpu.py): partial chunks, super-tiles and column tiles.
CHUNKED_T = (1, 7, 8, 9, 65, 1000, 1024)
CHUNKED_B = (1, 5, 33, 4100)
# (gamma, lambda) of the TD(lambda) loss and error: gamma*lambda = 0,
# lambda = 1, gamma = 1.
TD_CASES = ((0.9, 0.8), (0.9, 0.0), (0.95, 1.0), (1.0, 0.8), (1.0, 1.0))
# (gamma, lambda) of GAE: gamma*lambda = 0, lambda = 1 (the denominators
# grow to T - t), gamma = lambda = 1.
GAE_CASES = ((0.99, 0.97), (0.99, 0.0), (0.95, 1.0), (1.0, 1.0))
# The card tests' tilings (cols, chunks), and the shape they run at.
CHUNKED_TILINGS = ((32, 16), (16, 16), (32, 8), (1, 1), (1, 16), (8, 1),
                   (8, 3), (5, 7))
TILINGS_SHAPE = (1000, 70)


def chunked_scan_sweep(dev) -> dict:
    """The chunked scan kernels (6, 9, 10, 7, 8, 12) against their plain
    versions at every (T, B) of CHUNKED_T x CHUNKED_B, from their own seed:
    the linear recurrence both ways with a zero, a scalar and a large (B,)
    boundary (steps past T must be the identity, or the reverse walk loses
    the boundary), the TD(lambda) loss, error and returns at TD_CASES, GAE
    at GAE_CASES and the UPGO advantage plane and loss on normal and on
    integer-valued inputs (exact ties and sums: equal to the plain
    version), each bitwise repeatable; GAE also at the PPO trainer's (T,
    B), and GAE, the error and returns planes and both UPGO kernels at
    every CHUNKED_TILINGS tiling.  Returns the largest errors."""
    rng = np.random.default_rng(SEED + 18)
    # UPGO's inputs from a seed of their own, so that the other kernels'
    # inputs stay those of the sweep before it took UPGO.
    upgo_rng = np.random.default_rng(SEED + 21)
    worst = {"linear_scan": 0.0, "td_lambda_loss": 0.0, "td_lambda_err": 0.0,
             "gae": 0.0, "lambda_returns": 0.0, "upgo_loss": 0.0,
             "upgo_advantages": 0.0}

    def check(name, label, run, want, exact=False):
        got = run()
        if not torch.equal(got, run()):
            raise AssertionError(f"{name} {label}: repeated runs differ")
        if exact and not torch.equal(got, want):
            raise AssertionError(f"{name} {label}: not the plain version's "
                                 f"values")
        err = compare(f"{name} {label}", [got], [want])["max_abs_err"]
        worst[name] = max(worst[name], err)

    def upgo_inputs(T, B, integer):
        if integer:
            reward, value, lp = (torch.from_numpy(upgo_rng.integers(
                -2, 3, s).astype(np.float32)).to(dev)
                for s in ((T, B), (T + 1, B), (T, B)))
            return torch.ones((T, B), device=dev), lp, reward, value
        g = lambda *s: torch.from_numpy(upgo_rng.standard_normal(
            s, dtype=np.float32)).to(dev)
        return torch.exp(0.3 * g(T, B)), -g(T, B).abs(), g(T, B), g(T + 1, B)

    def scan_cases(T, B, value, reward, names):
        for name in names:
            cases = GAE_CASES if name == "gae" else TD_CASES
            for scalars in cases:
                check(name, f"T={T} B={B} {scalars}",
                      lambda: getattr(kernels, name)(value, reward, *scalars),
                      getattr(kernels, name + "_plain")(value, reward,
                                                        *scalars))

    shapes = 0
    f = lambda *s: torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(dev)
    for T in CHUNKED_T:
        for B in CHUNKED_B:
            a, b = f(T, B), torch.from_numpy(rng.uniform(
                0.5, 1.0, (T, B)).astype(np.float32)).to(dev)
            for y in (None, torch.tensor(3.0, device=dev),
                      100 * torch.linspace(-1, 1, B, device=dev)):
                for reverse in (True, False):
                    got = kernels.linear_scan(a, b, y, reverse)
                    want = kernels.linear_scan_plain(
                        a, b, None if y is None else y.expand(B), reverse)
                    err = compare(f"linear_scan T={T} B={B} {reverse}",
                                  [got], [want])["max_abs_err"]
                    worst["linear_scan"] = max(worst["linear_scan"], err)
            value, reward = f(T + 1, B), f(T, B)
            scan_cases(T, B, value, reward,
                       ("td_lambda_loss", "td_lambda_err", "gae",
                        "lambda_returns"))
            for integer in (False, True):
                args = upgo_inputs(T, B, integer)
                check("upgo_loss", f"T={T} B={B} integer={integer}",
                      lambda: kernels.upgo_loss(*args),
                      kernels.upgo_loss_plain(*args), exact=integer)
                adv_args = (args[0], *args[2:])
                check("upgo_advantages", f"T={T} B={B} integer={integer}",
                      lambda: kernels.upgo_advantages(*adv_args),
                      kernels.upgo_advantages_plain(*adv_args),
                      exact=integer)
            shapes += 1
    T, B = PPO_CFG["T"], PPO_CFG["B"]
    scan_cases(T, B, f(T + 1, B), f(T, B), ("gae",))
    T, B = TILINGS_SHAPE
    value, reward = f(T + 1, B), f(T, B)
    tiled = [(name, (value, reward, *SCAN_ARGS[name]))
             for name in ("gae", "td_lambda_err", "lambda_returns")]
    args = upgo_inputs(T, B, False)
    tiled += [("upgo_loss", args), ("upgo_advantages", (args[0], *args[2:]))]
    for name, args in tiled:
        launch = getattr(kernels.rl_scans, f"_{name}_cuda")
        want = getattr(kernels, name + "_plain")(*args)
        for cols, chunks in CHUNKED_TILINGS:
            check(name, f"T={T} B={B} {cols}x{chunks}",
                  lambda: launch(*args, cols=cols, chunks=chunks), want)
    return {"shapes": shapes, "T": CHUNKED_T, "B": CHUNKED_B,
            "td_cases": TD_CASES, "gae_cases": GAE_CASES,
            "gae_ppo_shape": (PPO_CFG["T"], PPO_CFG["B"]),
            "tilings": CHUNKED_TILINGS, "tilings_shape": TILINGS_SHAPE,
            "bitwise_repeatable": True, "upgo_integer_inputs_exact": True,
            "max_abs_err": worst}


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


# The chunked UPGO kernels' instantiations, for chunked_launch_info.
UPGO_LOSS_INSTANCES = {"loss": ("upgo_chunked_kernel", "UpgoEpilogueE0")}
UPGO_ADV_INSTANCES = {"advantages": ("upgo_chunked_kernel",
                                     "UpgoEpilogueE1")}
# name -> (launch-shape function, instantiations, the wrapper's launch).
UPGO_CHUNKED = {
    "upgo_advantages": ("upgo_advantages_launch_shape", UPGO_ADV_INSTANCES,
                        "_upgo_advantages_cuda"),
    "upgo_loss": ("upgo_loss_launch_shape", UPGO_LOSS_INSTANCES,
                  "_upgo_loss_cuda")}


def full_plane_kernel_rows(rng, dev) -> dict:
    """Kernels 6, 11 and 12 against their plain versions at T=1024, B=4096
    (timed, with bounds), at a ragged B and at T=1; the linear recurrence in
    both directions with a zero, a scalar and a (B,) boundary; each with
    its launch (tiling, ptxas), its T=1024 rows also timing the chosen
    tiling against SCAN_OTHER_TILINGS, and kernel 12's the kernel alone
    (upgo_loss_kernel_alone_ms); both UPGO kernels must be bitwise
    repeatable."""
    from di_hpc_tpu_torch.kernels.linear_scan import _linear_scan

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
            row["launch"] = chunked_launch_info(
                kernels.linear_scan_launch_shape, T, B,
                {direction: ("linear_scan_chunked_kernel",
                             f"ILb{int(reverse)}E")})
            if T == 1024:
                row.update(kernel_ms(lambda: kernels.linear_scan(
                    a, b, None, reverse), per_rep=10))
                row["plain_ms"] = cuda_ms(lambda: kernels.linear_scan_plain(
                    a, b, None, reverse), 3, warmup=1)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    *linear_scan_bound(T, B, boundary=False))
                row["candidates"] = chunked_candidates(
                    lambda **tiling: _linear_scan(a, b, None, reverse,
                                                  **tiling),
                    kernels.linear_scan_launch_shape, T, B)
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
            if not torch.equal(got, again):
                raise AssertionError(f"{name}: repeated runs differ")
            shape_fn, instances, launch = UPGO_CHUNKED[name]
            shape_fn = getattr(kernels, shape_fn)
            launch = getattr(kernels.rl_scans, launch)
            row = {"shape": f"T={T},B={B}", "bitwise_repeatable": True,
                   **compare(f"{name} T={T},B={B}", [got], [plain(*args)]),
                   "launch": chunked_launch_info(shape_fn, T, B, instances)}
            if T == 1024:
                row.update(kernel_ms(lambda: wrapper(*args), per_rep=10))
                row["plain_ms"] = cuda_ms(lambda: plain(*args), 3, warmup=1)
                row["bound_ms"], row["bound_by"] = bound_ms(*bounds[name])
                row["candidates"] = chunked_candidates(
                    lambda **tiling: launch(*args, **tiling), shape_fn, T, B)
                if name == "upgo_loss":
                    row["kernel_alone_ms"] = upgo_loss_kernel_alone_ms(*args)
            rows[f"{name} T={T}"] = row
    return rows


def upgo_loss_kernel_alone_ms(rhos, lp, reward, value) -> float:
    """The UPGO loss kernel's cold time without its wrapper's work: the
    input checks, the tiling, the partials' allocation, `parts.sum` and the
    scaling stay outside the timed call, which is the entry point alone."""
    T, B = reward.shape
    parts = torch.empty((1, B), device=reward.device)
    tiling = kernels.rl_scans._tiling(kernels.upgo_loss_launch_shape, reward,
                                      None, None)
    entry = _build.library().cdll.upgo_loss_f32
    ptrs = [t.data_ptr() for t in (rhos, lp, reward, value, parts)]
    stream = torch.cuda.current_stream().cuda_stream
    _build.check_status("upgo_loss", entry(*ptrs, T, B, *tiling, stream))
    return cold_ms(lambda: entry(*ptrs, T, B, *tiling, stream))


def bound_ms(nbytes, flops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fwd_launch_info(B, H, item, stash, rows=None) -> dict:
    """Kernel 1's launch at (B, H) with `item`-byte streams: the route
    (cluster, or one CTA per 8 rows where H % 4 != 0), cluster size, rows
    per group, groups, grid, shared memory, how many of its clusters the
    card holds at once (cudaOccupancyMaxActiveClusters) and ptxas'
    registers and spills of the instantiation that runs."""
    lib = _build.library()
    shape = kernels.layer_launch_shape(B, H, item, rows)
    dt = "I13__nv_bfloat16" if item == 2 else "If"
    if shape["route"] == "cluster":
        kernel = "lstm_layer_cluster_kernel"
        tag = f"{dt}Li{shape['rows_per_group']}ELb{int(stash)}E"
    else:
        kernel, tag = "lstm_layer_fwd_kernel", f"{dt}Lb{int(stash)}E"
    return {**shape, "ptxas": ptxas_of(lib.build_log, kernel, tag)}


def fwd_kernel_row(name, args) -> dict:
    """One row of kernel 1 (`name`: lstm_layer_fused or lstm_layer_stash):
    against its plain version (f32 at RTOL/ATOL, bf16 at compare_bf16's
    bound), a second run bitwise equal to the first, times, the bound
    (3xTF32 or bf16 tensor-core rate) and the launch."""
    S, B, G = args[0].shape
    H, item = G // 4, args[0].element_size()
    stash = name.endswith("stash")
    wrapper = getattr(kernels, name)
    plain = kernels.lstm_layer_stash_plain if stash \
        else kernels.lstm_layer_plain
    got = wrapper(*args)
    again = wrapper(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{name} S={S} B={B} H={H}: repeated runs "
                             f"differ")
    want = plain(*args)
    row = {"shape": f"S={S},B={B},H={H}", "bitwise_repeatable": True,
           "launch": fwd_launch_info(B, H, item, stash)}
    label = f"{name} {args[0].dtype} S={S} B={B} H={H}"
    if item == 2:
        row.update(BF16_TOLERANCE)
        row.update(compare_bf16(label, got, want,
                                spread_vs_cpu(plain, args, want)))
    else:
        row.update(compare(label, got, want))
    row.update(kernel_ms(lambda: wrapper(*args), per_rep=3))
    row["plain_ms"] = cuda_ms(lambda: plain(*args), 5)
    nbytes, flops = lstm_bound(S, B, H, item)
    if stash:
        nbytes += item * S * B * H
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes, flops, BF16_FLOP_PER_S if item == 2 else TF32X3_FLOP_PER_S)
    return row


def rows_candidates(args, first, second) -> dict:
    """The cluster kernel's cold time at `first` and at `second` rows per
    group, in turns (first, second, second, first), each with its launch
    shape."""
    S, B, G = args[0].shape
    H, item = G // 4, args[0].element_size()
    out = {}
    for rows in (first, second, second, first):
        ms = cold_ms(lambda: kernels.lstm_cell._lstm_layer_cuda(
            *args, norm=True, stash=False, rows=rows))
        cand = out.setdefault(str(rows), {
            **kernels.layer_launch_shape(B, H, item, rows), "ms": []})
        cand["ms"].append(ms)
    return out


# Kernel 1's rows beyond the main paths' shapes, in f32 and in bf16, each
# from its own seed so that the earlier rows keep their inputs: B = 64 and
# the ragged B = 200 at S=33, the AlphaStar-sized B = 8 at S=1 (timed at 8
# against 24 rows per group too), and (f32) one H % 4 != 0 width, which
# runs the 8-row kernel.
FWD_EXTRA_ROWS = ((33, 64, 512), (33, 200, 512), (1, 8, 512))
FWD_ROUTE_ROW = (33, 64, 510)


def fwd_extra_rows(dev, dtype) -> dict:
    rows = {}
    extra = np.random.default_rng(SEED + (13 if dtype == torch.float32
                                          else 14))
    tag = "" if dtype == torch.float32 else " bf16"
    shapes = FWD_EXTRA_ROWS + ((FWD_ROUTE_ROW,) if tag == "" else ())
    for S, B, H in shapes:
        args = lstm_inputs(extra, S, B, H, dev, dtype)
        key = f"lstm_layer_fused{tag} S={S} B={B}" + \
            ("" if H == 512 else f" H={H}")
        rows[key] = fwd_kernel_row("lstm_layer_fused", args)
        if B == 8:
            rows[key]["rows_candidates"] = rows_candidates(args, 8, 24)
    return rows


def phase_kernels(dev) -> dict:
    rng = np.random.default_rng(SEED)
    rows = {"tolerance": {"rtol": RTOL, "atol": ATOL}}
    with torch.inference_mode():
        # LSTM layer at the forward's unroll and at the serving step, then
        # in stash mode at the train step's unroll.
        B, H = 256, 512
        for name, S in (("lstm_layer_fused", 33), ("lstm_layer_fused", 1),
                        ("lstm_layer_stash", 33)):
            args = lstm_inputs(rng, S, B, H, dev)
            rows[f"{name} S={S}"] = fwd_kernel_row(name, args)
            if name == "lstm_layer_fused" and S == 33:
                rows[f"{name} S={S}"]["rows_candidates"] = \
                    rows_candidates(args, 24, 16)
        rows.update(fwd_extra_rows(dev, torch.float32))
        rows.update(bwd_kernel_rows(rng, dev))

        rows.update(vtrace_kernel_rows(rng, dev))
        rows.update(categorical_kernel_rows(dev))
        rows.update(scan_kernel_rows(rng, dev))
        rows.update(full_plane_kernel_rows(rng, dev))
        rows.update(bf16_kernel_rows(rng, dev))
        rows["chunked_scan_sweep"] = chunked_scan_sweep(dev)
    return rows


def compare_bf16(name, got, want, spread) -> dict:
    """compare() of bf16 outputs in float32 at the BF16_REL bound, widened
    per output by twice its CPU-vs-card spread."""
    out = {"max_abs_err": 0.0, "max_err_over_max": 0.0, "spread": spread}
    for i, (g, w, sp) in enumerate(zip(got, want, spread)):
        if g.dtype != w.dtype:
            raise AssertionError(f"{name}[{i}]: {g.dtype} vs {w.dtype}")
        c = compare(f"{name}[{i}]", [g], [w], rtol=0.0, atol=2 * sp,
                    atol_rel=BF16_REL)
        out["max_abs_err"] = max(out["max_abs_err"], c["max_abs_err"])
        out["max_err_over_max"] = max(out["max_err_over_max"],
                                      c["max_err_over_max"])
    return out


def spread_vs_cpu(plain, args, want) -> list:
    """Per output: max |plain(args on the CPU) - want| of the card's plain
    run `want`."""
    cpu = plain(*[a.cpu() for a in args])
    return [float((c.float() - w.float().cpu()).abs().max())
            for c, w in zip(cpu, want)]


BF16_TOLERANCE = {"tolerance": {
    "atol_rel_to_max": BF16_REL,
    "plus": "2 x the plain version's CPU-vs-card spread"}}


def bf16_kernel_rows(rng, dev) -> dict:
    """The bf16 instantiations of the LSTM kernels at the f32 rows' shapes,
    each against its plain bf16 version on the card (BF16_REL bound),
    repeatability, times, and bounds at the bf16 tensor-core peak and at
    bf16 bytes."""
    rows = {}
    H, bf16 = 512, torch.bfloat16
    tol = BF16_TOLERANCE
    for name, S, B in (("lstm_layer_fused", 33, 256),
                       ("lstm_layer_stash", 33, 256),
                       ("lstm_layer_fused", 1, 256)):
        args = lstm_inputs(rng, S, B, H, dev, bf16)
        rows[f"{name} bf16 S={S}"] = fwd_kernel_row(name, args)
        if name == "lstm_layer_fused" and S == 33:
            rows[f"{name} bf16 S={S}"]["rows_candidates"] = \
                rows_candidates(args, 24, 16)
    rows.update(fwd_extra_rows(dev, bf16))

    extra = np.random.default_rng(SEED + 12)
    for name, S, B, H in BWD_ROWS:
        args = [a.to(bf16) for a in bwd_inputs(
            rng if train_row(B, H) else extra, S, B, H, dev)]
        gxp, _, _, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn, dcn = \
            args
        y, c_seq, _, _ = kernels.lstm_layer_stash(gxp, wh, glnx, blnx, gln,
                                                  bln, bias, h0, c0)
        args[1], args[2] = y, c_seq
        if name.endswith("v1"):
            args = (*kernels.lstm_layer_bwd_v1_streams(
                gxp, y, c_seq, wh, glnx, blnx, bias, h0, c0), c_seq, dy, wh,
                gln, bln, dhn, dcn)
        wrapper = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        got = wrapper(*args)
        again = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        row = {"shape": f"S={S},B={B},H={H}", **tol}
        bwd_launch_checks(name, row, got, again, B, H, item=2)
        row.update(compare_bf16(f"{name} bf16 B={B} H={H}", got, want,
                                spread_vs_cpu(plain, args, want)))
        row.update(kernel_ms(lambda: wrapper(*args), per_rep=3))
        row["plain_ms"] = cuda_ms(lambda: plain(*args), 3, warmup=1)
        row["bound_ms"], row["bound_by"] = bound_ms(
            *lstm_bwd_bound(name[-2:], S, B, H, item=2), BF16_FLOP_PER_S)
        if name.endswith("v1") and B in (32, 8):
            row["candidates"] = v1_candidates(args)
        rows[bwd_row_key(name + " bf16", S, B, H)] = row
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

# The backward kernels' rows (name, S, B, H), in f32 and in bf16: V2 at the
# train step's B=256, at the smallest batch it serves (V2_MIN_BATCH = 64)
# and at a B that leaves a partial last group of rows; V1 at the train
# step's B=32, at the ragged B=40 and at the AlphaStar step's core (S = T+1
# = 17, B=8, H=128).  The train step's rows draw their inputs from the
# phase's generator, the others from one of their own, in this order.
BWD_ROWS = (("lstm_layer_bwd_v2", 33, 256, 512),
            ("lstm_layer_bwd_v2", 33, 64, 512),
            ("lstm_layer_bwd_v2", 33, 200, 512),
            ("lstm_layer_bwd_v1", 33, 32, 512),
            ("lstm_layer_bwd_v1", 33, 40, 512),
            ("lstm_layer_bwd_v1", 17, 8, 128))


def train_row(B, H) -> bool:
    return B in (256, 32) and H == 512


def bwd_row_key(name, S, B, H):
    """The row's key: the train step's B is the row the kernels line
    reads."""
    if train_row(B, H):
        return f"{name} S={S}"
    return f"{name} S={S} B={B}" + ("" if H == 512 else f" H={H}")


def ptxas_of(log, kernel, tag) -> list:
    """ptxas' register, stack and spill lines for the instantiation of
    `kernel` whose mangled name holds `tag`."""
    out, on = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            on = kernel in ln and tag in ln
        elif on and ("Used" in ln or "spill" in ln):
            out.append(ln.split(":", 1)[-1].strip())
    return out


def v2_launch_info(B, H, item) -> dict:
    """V2's launch at (B, H) with `item`-byte streams: rows per group,
    cluster size, groups, grid, how many of its clusters the card holds at
    once (cudaOccupancyMaxActiveClusters) and ptxas' registers and
    spills."""
    lib = _build.library()
    shape = kernels.v2_launch_shape(B, H, item)
    tag = ("I13__nv_bfloat16" if item == 2 else "If") + \
        f"Li{shape['rows_per_group']}E"
    return {**shape,
            "max_active_clusters":
                lib.cdll.lstm_layer_bwd_v2_max_active_clusters(B, H, item),
            "smem_bytes": lib.cdll.lstm_layer_bwd_v2_smem_bytes(H, item),
            "ptxas": ptxas_of(lib.build_log, "lstm_layer_bwd_v2_kernel", tag)}


def v1_launch_info(B, H, item, cluster=None) -> dict:
    """V1's launch at (B, H) with `item`-byte streams, as v2_launch_info
    reports V2's (`cluster` overrides the route's cluster size)."""
    lib = _build.library()
    shape = kernels.v1_launch_shape(B, H, item, cluster)
    tag = ("I13__nv_bfloat16" if item == 2 else "If") + \
        f"Li{shape['rows_per_group']}E"
    return {**shape,
            "max_active_clusters":
                lib.cdll.lstm_layer_bwd_v1_max_active_clusters(
                    B, H, item, shape["cluster"], shape["rows_per_group"]),
            "ptxas": ptxas_of(lib.build_log, "lstm_layer_bwd_v1_kernel", tag)}


def v1_candidates(args) -> dict:
    """V1's cold time with clusters of 8 and of 16 CTAs, in turns (8, 16,
    16, 8), each with its launch."""
    S, B, G = args[0].shape
    H, item = G // 4, args[0].element_size()
    out = {}
    for cluster in (8, 16, 16, 8):
        ms = cold_ms(lambda: kernels.lstm_cell._lstm_layer_bwd_v1_cuda(
            *args, norm=True, cluster=cluster))
        cand = out.setdefault(str(cluster), {
            **v1_launch_info(B, H, item, cluster), "ms": []})
        cand["ms"].append(ms)
    return out


def bwd_launch_checks(name, row, got, again, B, H, item) -> None:
    """A backward row's second run bitwise equal to its first, and its
    launch (V2's or V1's)."""
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{name} B={B} H={H} item={item}: repeated "
                             f"runs differ")
    row["bitwise_repeatable"] = True
    row["launch"] = (v2_launch_info(B, H, item) if name.endswith("v2")
                     else v1_launch_info(B, H, item))


def bwd_kernel_rows(rng, dev) -> dict:
    """Both LSTM backward kernels against their plain versions at
    BWD_ROWS' shapes, their repeatability and launch, V1's cluster sizes
    timed in turns, and the layer's autograd.Function against autograd
    through the plain forward."""
    rows = {}
    extra = np.random.default_rng(SEED + 11)
    for name, S, B, H in BWD_ROWS:
        args = bwd_inputs(rng if train_row(B, H) else extra, S, B, H, dev)
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
        bwd_launch_checks(name, row, got, again, B, H, item=4)
        row.update(compare(f"{name} B={B} H={H}", got, want,
                           atol_rel=BWD_ATOL_REL))
        row.update(kernel_ms(lambda: wrapper(*args), per_rep=3))
        row["plain_ms"] = cuda_ms(lambda: plain(*args), 3, warmup=1)
        row["bound_ms"], row["bound_by"] = bound_ms(
            *lstm_bwd_bound(name[-2:], S, B, H), TF32X3_FLOP_PER_S)
        if name.endswith("v1") and B in (32, 8):
            row["candidates"] = v1_candidates(args)
        rows[bwd_row_key(name, S, B, H)] = row

    # The autograd.Function's 9 gradients at the train step's B=256 (V2),
    # against PyTorch's autograd through the plain forward, on the card.
    S, B, H = 33, 256, 512
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


def train_setup(arrays, batch_np, dev, compute_dtype=None):
    """Params on dev, their Adam(lr=1e-3) train step (in compute_dtype), and
    the batch."""
    params = models.from_jax_params(arrays, device=dev)
    step = models.make_train_step(
        models.ActorCriticConfig(OBS, HID, LAYERS, ACTIONS),
        torch.optim.Adam(params.parameters(), lr=1e-3),
        compute_dtype=compute_dtype)
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
        network.reset_route_counts()
        metrics = step(params, batch)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        routes = dict(network.lstm_fused.routes)
        check_launched(f"train B={B}", launches, ("lstm_layer_fused", bwd,
                                                  "vtrace_losses",
                                                  "vtrace_returns_adv"))
        if routes != {"kernel": LAYERS, "recurrent": 0}:
            raise AssertionError(f"train B={B}: the layers' routes are "
                                 f"{routes}, not the kernels")
        ref_params, ref_step, ref_batch = train_setup(arrays, batch_np, cpu)
        ref = ref_step(ref_params, ref_batch)
        leg = {"launches": launches, "lstm_fused_routes": routes,
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
    out["routing"] = routed_layer_leg(dev)
    return out


# network.lstm_fused with a gradient at a width the kernels cannot take
# backwards (H % 4 != 0): each layer takes the recurrent path on the card.
ROUTE_CFG = {"S": 8, "B": 4, "I": 32, "H": 30, "L": 2}


def routed_layer(arrays, dev):
    """lstm_fused over ROUTE_CFG's shapes on dev with the gradient of a fixed
    loss: [y, h, c, d inputs, d every parameter]."""
    params = network.LSTMParams(*(
        tuple(torch.from_numpy(w).to(dev).requires_grad_() for w in f)
        if isinstance(f, tuple) else
        torch.from_numpy(f).to(dev).requires_grad_() for f in arrays[:-1]))
    x = torch.from_numpy(arrays[-1]).to(dev).requires_grad_()
    y, (h, c) = network.lstm_fused(params, x)
    ((y * torch.cos(y)).sum() + (h ** 2).sum() + torch.sin(c).sum()
     ).backward()
    leaves = [x, *params.wx, *params.wh, params.bias, *params[3:]]
    return [y, h, c, *(t.grad for t in leaves)]


def routed_layer_leg(dev) -> dict:
    """ROUTE_CFG's lstm_fused with its gradient on the card, counts set to 0
    just before it and read just after: every layer must take the recurrent
    path and launch no kernel; outputs and gradients against the CPU (whose
    kernel wrappers run their plain versions)."""
    rng = np.random.default_rng(SEED + 19)
    S, B, I, H, L = (ROUTE_CFG[k] for k in "SBIHL")
    g = 1 / np.sqrt(H)
    u = lambda *s: rng.uniform(-g, g, s).astype(np.float32)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)
    arrays = (tuple(u(I if l == 0 else H, 4 * H) for l in range(L)),
              tuple(u(H, 4 * H) for _ in range(L)), u(L, 4 * H),
              1 + 0.1 * n(L, 4 * H), 0.1 * n(L, 4 * H),
              1 + 0.1 * n(L, 4 * H), 0.1 * n(L, 4 * H), n(S, B, I))
    kernels.reset_launch_counts()
    network.reset_route_counts()
    got = routed_layer(arrays, dev)
    torch.cuda.synchronize()
    launches, routes = kernels.launch_counts(), dict(network.lstm_fused.routes)
    if routes != {"kernel": 0, "recurrent": L} or any(launches.values()):
        raise AssertionError(f"routing: routes {routes}, launches "
                             f"{launches}")
    want = routed_layer(arrays, torch.device("cpu"))
    return {"shape": ROUTE_CFG, "lstm_fused_routes": routes,
            "vs_cpu": compare("routing", got, want, atol_rel=GRAD_ATOL_REL)}


# ------------------------------------------------------------ phase 6 ----

BF16_LEGS = ((256, "lstm_layer_bwd_v2_bf16"), (32, "lstm_layer_bwd_v1_bf16"))
BF16_SERVE_STEPS = 16
# The bf16 step on the card against the same bf16 step on the CPU: both run
# the same bf16 program, but every bf16 GEMM and kernel output is rounded
# after sums taken in another order, a value near a rounding boundary goes
# the other way, and the 33-step recurrence carries that on: the kernel
# rows' plain version alone moves by up to 0.0625 (6 % of max|y|) between
# the CPU and the card after one 33-step layer, and the model runs two.
# Metrics: rtol and atol BF16_METRIC_TOL; outputs and gradients:
# BF16_OUT_REL and BF16_GRAD_REL times the tensor's largest |entry|.
BF16_METRIC_TOL = 1e-2
BF16_OUT_REL = 1e-1
BF16_GRAD_REL = 1e-1
# bf16 against float32: the bounds of JAX's own bf16 LSTM test
# (tests/test_pallas_fused.py:376-397).
VS_F32_OUT, VS_F32_GRAD_REL = 0.15, 0.25


def bf16_model(arrays, dev):
    return models.from_jax_params(arrays, device=dev).to(torch.bfloat16)


def run_bf16_inference(params, obs, serve_obs, gen, dev):
    """A bf16 forward over the unroll and BF16_SERVE_STEPS serving steps
    with the state carried: every output."""
    with torch.inference_mode():
        logits, value, (h, c) = models.actor_critic_forward(params, obs)
        state = (torch.zeros(LAYERS, B_FWD, HID, device=dev,
                             dtype=torch.bfloat16),) * 2
        serve_logits = []
        for t in range(BF16_SERVE_STEPS):
            action, step_logits, step_value, state = models.actor_step(
                params, serve_obs[t], state, gen)
            serve_logits.append(step_logits)
    return {"logits": logits, "value": value, "h": h, "c": c,
            "serve_logits": torch.stack(serve_logits),
            "serve_value": step_value, "serve_h": state[0],
            "serve_c": state[1], "serve_action": action}


def run_remat(params, x):
    """network.lstm_fused(remat=True) over x and the gradient of a fixed
    loss in the LSTM's parameters: (y, grads)."""
    lstm = params.lstm
    y, (h, c) = network.lstm_fused(lstm.params(), x, None, "LN", remat=True)
    (y.float().square().mean() + (h * c).float().mean()).backward()
    return y.detach(), [p.grad for p in lstm.parameters()]


def check_finite(name, tensors) -> None:
    for i, t in enumerate(tensors):
        if t.is_floating_point() and not torch.isfinite(t).all():
            raise AssertionError(f"{name}[{i}]: non-finite values")


def phase_bf16(dev) -> dict:
    rng = np.random.default_rng(SEED + 8)
    arrays = model_arrays(rng)
    batches = {B: train_batch(rng, B) for B, _ in BF16_LEGS}
    obs_np = rng.standard_normal((T_FWD + 1, B_FWD, OBS), dtype=np.float32)
    serve_np = rng.standard_normal((BF16_SERVE_STEPS, B_FWD, OBS),
                                   dtype=np.float32)
    remat_x = rng.standard_normal((T_FWD + 1, B_FWD, HID), dtype=np.float32)
    bf16 = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)
    obs, serve_obs, x = bf16(obs_np), bf16(serve_np), bf16(remat_x)
    legs = {B: train_setup(arrays, batches[B], dev, torch.bfloat16)
            for B, _ in BF16_LEGS}
    infer_params, remat_params = bf16_model(arrays, dev), bf16_model(arrays,
                                                                     dev)
    torch.cuda.synchronize()

    # The counted run: both train legs, the forward and serving loop, the
    # remat forward + backward.
    kernels.reset_launch_counts()
    metrics = {B: legs[B][1](legs[B][0], legs[B][2]) for B in legs}
    infer = run_bf16_inference(infer_params, obs, serve_obs,
                               torch.Generator(device=dev).manual_seed(SEED),
                               dev)
    remat_y, remat_grads = run_remat(remat_params, x)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launched("bf16", launches, ("lstm_layer_fused_bf16",
                                      "lstm_layer_bwd_v2_bf16",
                                      "lstm_layer_bwd_v1_bf16",
                                      "vtrace_losses", "vtrace_returns_adv"))
    for name, ts in (("bf16 infer", infer.values()),
                     ("bf16 remat", [remat_y, *remat_grads]),
                     *((f"bf16 train B={B}",
                        [*metrics[B].values(),
                         *(p.grad for p in legs[B][0].parameters())])
                       for B in legs)):
        check_finite(name, ts)

    cpu = torch.device("cpu")
    out = {"launches": launches,
           "tolerance": {"vs_cpu": {"metrics": BF16_METRIC_TOL,
                                    "outputs_rel_to_max": BF16_OUT_REL,
                                    "grads_rel_to_max": BF16_GRAD_REL},
                         "vs_f32": {"outputs": VS_F32_OUT,
                                    "grads_rel_to_max": VS_F32_GRAD_REL}}}
    for B, _ in BF16_LEGS:
        params = legs[B][0]
        ref_params, ref_step, ref_batch = train_setup(arrays, batches[B], cpu,
                                                      torch.bfloat16)
        ref = ref_step(ref_params, ref_batch)
        f32_params, f32_step, f32_batch = train_setup(arrays, batches[B], dev)
        f32 = f32_step(f32_params, f32_batch)
        leg = {"metrics": {k: float(v) for k, v in metrics[B].items()},
               "metrics_vs_cpu": compare(
                   f"bf16 train B={B} metrics", list(metrics[B].values()),
                   list(ref.values()), rtol=BF16_METRIC_TOL,
                   atol=BF16_METRIC_TOL),
               "metrics_vs_f32": compare(
                   f"bf16 train B={B} metrics vs f32",
                   list(metrics[B].values()), list(f32.values()),
                   rtol=VS_F32_OUT, atol=VS_F32_OUT)}
        worst_cpu, worst_f32 = 0.0, 0.0
        for (name, p), (_, q), (_, r) in zip(params.named_parameters(),
                                             ref_params.named_parameters(),
                                             f32_params.named_parameters()):
            worst_cpu = max(worst_cpu, compare(
                f"bf16 train B={B} grad {name}", [p.grad], [q.grad],
                rtol=0.0, atol=0.0, atol_rel=BF16_GRAD_REL)[
                "max_err_over_max"])
            worst_f32 = max(worst_f32, compare(
                f"bf16 train B={B} grad {name} vs f32", [p.grad], [r.grad],
                rtol=0.0, atol=0.0, atol_rel=VS_F32_GRAD_REL)[
                "max_err_over_max"])
        leg["grads_vs_cpu_max_err_over_max"] = worst_cpu
        leg["grads_vs_f32_max_err_over_max"] = worst_f32
        step, batch = legs[B][1], legs[B][2]
        leg[f"ms_per_bf16_train_step_T{T_TR}_B{B}"] = host_ms(
            lambda: step(params, batch), TRAIN_TIMED_STEPS)
        out[f"B={B}"] = leg

    ref = run_bf16_inference(bf16_model(arrays, cpu), obs.cpu(),
                             serve_obs.cpu(),
                             torch.Generator().manual_seed(SEED), cpu)
    out["infer_vs_cpu"] = {
        k: compare(f"bf16 {k}", [infer[k]], [ref[k]], rtol=0.0, atol=0.0,
                   atol_rel=BF16_OUT_REL)
        for k in infer if k != "serve_action"}
    # The recurrent path in bf16 rounds at every op, and its 33-step
    # recurrence is chaotic at that precision: changing one input entry by
    # one bf16 ulp moves the CPU's own bf16 output by 0.28 of max|y|.  So
    # the card's bf16 remat run is reported against the CPU's, unbounded,
    # and the path itself is held in float32, card against CPU.
    ref_y, ref_grads = run_remat(bf16_model(arrays, cpu), x.cpu())
    out["remat_bf16_vs_cpu_unbounded"] = {
        "y_max_err_over_max": float((remat_y.float().cpu() - ref_y.float())
                                    .abs().max() / ref_y.float().abs().max()),
        "grads_max_err_over_max": max(
            float((g.float().cpu() - r.float()).abs().max()
                  / r.float().abs().max())
            for g, r in zip(remat_grads, ref_grads))}
    f32_y, f32_grads = run_remat(models.from_jax_params(arrays, device=dev),
                                 x.float())
    ref_y, ref_grads = run_remat(models.from_jax_params(arrays, device=cpu),
                                 x.float().cpu())
    out["remat_f32_vs_cpu"] = {
        "y": compare("f32 remat y", [f32_y], [ref_y]),
        "grads": compare("f32 remat grads", f32_grads, ref_grads, atol=0.0,
                         atol_rel=GRAD_ATOL_REL)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    serve_state = (torch.zeros(LAYERS, B_FWD, HID, device=dev,
                               dtype=torch.bfloat16),) * 2

    def forward():
        with torch.inference_mode():
            models.actor_critic_forward(infer_params, obs)

    def serve():
        st = serve_state
        with torch.inference_mode():
            for t in range(BF16_SERVE_STEPS):
                st = models.actor_step(infer_params, serve_obs[t], st, gen)[3]

    out["ms_per_bf16_forward_S33_B256"] = host_ms(forward, 7)
    out["ms_per_bf16_actor_step_B256"] = host_ms(serve, 3) / BF16_SERVE_STEPS
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


# ------------------------------------------------------------ phase 7 ----

def example_modules() -> SimpleNamespace:
    """The port's PPO, AlphaStar, R2D2, C51 and quantile-DQN examples,
    imported here and not at the top, so that --digests and --profile still
    run in an older checkout that lacks them."""
    from di_hpc_tpu_torch.examples import (
        alphastar_policy_training, c51_training, ppo_training,
        quantile_dqn_training, r2d2_training)
    return SimpleNamespace(ppo=ppo_training,
                           alphastar=alphastar_policy_training,
                           r2d2=r2d2_training, c51=c51_training,
                           quantile=quantile_dqn_training)


def have_examples() -> bool:
    """Whether this checkout has the modules of example_modules()."""
    return importlib.util.find_spec(
        "di_hpc_tpu_torch.examples.ppo_training") is not None


T_OP, B_OP = 1024, 4096             # GAE and TD(lambda): bench.py:550, :676
B_PPO, N_PPO = 4096, 128            # PPO: bench.py:441
# The PPO trainer of di_hpc_tpu_torch.examples.ppo_training with
# actions=128 and rollouts of T=16, B=256: each epoch's loss runs on a flat
# (4096, 128) batch.
PPO_CFG = {"obs_dim": 32, "hidden": 64, "actions": 128, "T": 16, "B": 256}
PPO_ITERS, PPO_EPOCHS = 2, 4
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


def ppo_setup(arrays, rollouts_np, dev):
    """The example's parameters (a PPOParams module: Adam updates them in
    place), their Adam and the rollouts, on dev."""
    p = models.from_jax_params(models.PPOArrays(**arrays), device=dev)
    rollouts = [tuple(torch.from_numpy(a).to(dev) for a in r)
                for r in rollouts_np]
    return (p, torch.optim.Adam(p.parameters(), lr=example_modules().ppo.LR),
            rollouts)


def ppo_train(arrays, rollouts_np, dev):
    """PPO_ITERS iterations of PPO_EPOCHS epochs of the example's
    `iteration`: the per-epoch log, the final parameters by name."""
    ppo = example_modules().ppo
    p, opt, rollouts = ppo_setup(arrays, rollouts_np, dev)
    log = [entry for r in rollouts
           for entry in ppo.iteration(p, opt, r, PPO_EPOCHS)]
    return log, dict(p.named_parameters())


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
              "tolerance": {"rtol": RTOL, "atol": ATOL,
                          "gradient_blocks": {"rtol": RTOL, "atol": 0.0,
                                              "atol_rel": PAR_GRAD_REL}},
              "check_vs_cpu": {k: compare(f"onpolicy {k}", [out[k]],
                                          [ref[k]]) for k in ref}}
    for i, ((m, g), (rm, rg)) in enumerate(zip(log, ref_log)):
        result["check_vs_cpu"][f"ppo epoch {i}"] = compare(
            f"ppo epoch {i} metrics", list(m.values()), list(rm.values()))
        for k in rg:
            compare(f"ppo epoch {i} grad {k}", [g[k]], [rg[k]], atol=0.0,
                    atol_rel=GRAD_ATOL_REL)
    result["ppo_params_vs_cpu"] = check_adam_params(
        "ppo", p, ref_p, [g for _, g in ref_log], example_modules().ppo.LR,
        len(ref_log))
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


def onpolicy_timed_calls(x, ppo_np, rollouts_np, dev, examples=True):
    """The three end-to-end calls that are timed: one ops.gae call, one
    td_lambda_error forward + backward and, with `examples`, one PPO
    iteration (collect and PPO_EPOCHS Adam steps)."""
    value = x["value"].clone().requires_grad_()

    def td_lambda():
        value.grad = None
        ops.td_lambda_error(ops.td_lambda_data(value, x["reward"], None),
                            0.9, 0.8).backward()

    calls = {
        "gae_T1024_B4096": lambda: ops.gae(ops.gae_data(
            x["value"], x["reward"]), 0.99, 0.97),
        "td_lambda_fwd_bwd_T1024_B4096": td_lambda}
    if examples:
        p, opt, rollouts = ppo_setup(ppo_np, rollouts_np, dev)
        calls["ppo_iteration_T16_B256_N128"] = lambda: example_modules(
            ).ppo.iteration(p, opt, rollouts[0], PPO_EPOCHS)
    return calls


# ------------------------------------------------------------ phase 8 ----

T_SC, B_SC = 1024, 4096                 # the scan entry points: bench.py:550
T_UG, B_UG, N_UG = 128, 512, 128        # ops.upgo_loss: bench.py:651
SC_B, SC_M, SC_N, SC_HW = 256, 256, 256, (16, 16)   # scatter: bench.py:609
# The train step of di_hpc_tpu_torch.examples.alphastar_policy_training in
# the JAX example's configuration (main's defaults,
# examples/alphastar_policy_training.py:61-63), its Adam(lr=3e-4), synthetic
# batches.
AS_CFG = {"T": 16, "B": 8, "M": 32, "De": 16, "N": 32, "H": 8, "W": 8,
          "F": 64, "Hc": 128, "A": 8, "Hs": 64}
AS_SELECTIONS, AS_STEPS = 6, 3
# The train step's arguments besides the batch: greedy selection (no
# generator), as the card-against-CPU checks need.
AS_STEP = {"H": AS_CFG["H"], "W": AS_CFG["W"],
           "max_selections": AS_SELECTIONS}
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


def run_scan_entry_points(x) -> dict:
    """The scan entry points under "auto" at T=1024, B=4096, each through
    kernel 6: the linear recurrence both ways, with a (B,) boundary and a
    row-constant b; the lambda-returns with (T, B) gamma and lambda planes;
    the UPGO returns."""
    return {"linear_reverse": ops.linear_recurrence_reverse(
                x["a"], x["b"], x["y"]),
            "linear_forward": ops.linear_recurrence_forward(
                x["a"], x["b_row"], 0.5),
            "lambda_returns": ops.generalized_lambda_returns(
                x["value"], x["reward"], x["gammas"], x["lambdas"]),
            "upgo_returns": ops.upgo_returns(x["reward"], x["value"])}


def run_upgo_ops(x) -> dict:
    """The scan entry points (run_scan_entry_points), the UPGO loss with
    its gradient and both scatter modes with theirs."""
    out = run_scan_entry_points(x)
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


def alphastar_setup(arrays, batches_np, dev):
    """Params on dev (copies: Adam updates them in place), their Adam and
    the batches, on dev."""
    p = models.from_jax_params(arrays, device=dev)
    batches = [to_dev(b, dev) for b in batches_np]
    lr = example_modules().alphastar.LR
    return p, torch.optim.Adam(p.parameters(), lr=lr), batches


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
    p, opt, batches = alphastar_setup(as_np, batches_np, dev)
    log, starts = [], []
    for batch in batches:
        starts.append((_cpu_copy(p.state_dict()),
                       copy.deepcopy(opt.state_dict())))
        log.append(example_modules().alphastar.train_step(p, opt, batch,
                                                          **AS_STEP))
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
    ref_p, ref_opt, ref_batches = alphastar_setup(as_np, batches_np, cpu)
    for i, ((m, g), (p_before, opt_before, p_after)) in enumerate(
            zip(log, starts)):
        ref_p.load_state_dict(p_before)
        ref_opt.load_state_dict(opt_before)
        rm, rg = example_modules().alphastar.train_step(
            ref_p, ref_opt, ref_batches[i], **AS_STEP)
        result["check_vs_cpu"][f"alphastar step {i}"] = compare(
            f"alphastar step {i} metrics", list(m.values()),
            list(rm.values()))
        for k in rg:
            compare(f"alphastar step {i} grad {k}", [g[k]], [rg[k]],
                    atol=0.0, atol_rel=GRAD_ATOL_REL)
        result["alphastar_params_vs_cpu"][f"step {i}"] = check_adam_params(
            f"alphastar step {i}", p_after, dict(ref_p.named_parameters()),
            [rg], example_modules().alphastar.LR, 1)
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


def upgo_timed_calls(x, as_np, batches_np, dev, examples=True):
    """The three end-to-end calls that are timed: one ops.upgo_loss forward
    + backward, one scatter add + gradient and, with `examples`, one
    AlphaStar train step."""
    calls = {
        "upgo_loss_fwd_bwd_T128_B512_N128": lambda: upgo_loss_fwd_bwd(x),
        "scatter_add_grad_B256_M256": lambda: scatter_fwd_bwd(x, "add")}
    if examples:
        p, opt, batches = alphastar_setup(as_np, batches_np[:1], dev)
        calls["alphastar_train_step_T16_B8"] = lambda: example_modules(
            ).alphastar.train_step(p, opt, batches[0], **AS_STEP)
    return calls


# ------------------------------------------------------------ phase 9 ----

# The batch-bound TD family at the JAX bench's shapes: q_nstep and its
# rescaled form at bench.py:1069-1089, C51 at bench.py:505-547, QR-DQN at
# the replay-learner scale of bench_results/profile_qrdqn_iqn_scale_r5.py
# (its gamma and nstep, :131-135), IQN at bench.py:1095-1117.
NS_Q = {"B": 64, "N": 64, "nstep": 5, "gamma": 0.95}
NS_C51 = {"B": 128, "N": 128, "n_atom": 51, "nstep": 10, "gamma": 0.95,
          "v_min": -10.0, "v_max": 10.0}
NS_QR = {"tau": 64, "B": 4096, "N": 64, "nstep": 3, "gamma": 0.99}
NS_IQN = {"tau": 33, "tau_prime": 34, "B": 64, "N": 8, "nstep": 10,
          "gamma": 0.95, "kappa": 0.9}
# The train step of di_hpc_tpu_torch.examples.r2d2_training in the JAX
# example's configuration (main's defaults, examples/r2d2_training.py:56-59),
# its Adam(lr=1e-3), the target net frozen at the first step's parameters
# (target_update_every=10), synthetic replay samples as the example draws
# them (:68-78).
R2D2_CFG = {"S": 20, "burn_in": 4, "B": 32, "obs_dim": 16, "hidden": 128,
            "actions": 8, "nstep": 3, "layers": 1, "gamma": 0.99}
# The train step's arguments besides the nets, the optimizer and the batch.
R2D2_STEP = {k: R2D2_CFG[k] for k in ("burn_in", "nstep", "gamma")}
R2D2_STEPS = 3
NSTEP_KERNELS = ("lstm_layer_fused", "lstm_layer_bwd_v1")


def nstep_arrays(rng):
    """numpy-made inputs of the five TD ops (NS_* shapes): Gaussian q
    tables, softmax distributions for C51, uniform actions, Gaussian
    rewards, dones with probability 0.1, the QR-DQN quantile midpoints and
    uniform IQN replay quantiles."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    ints = lambda n, b: rng.integers(0, n, (b,))
    done = lambda b: rng.uniform(0, 1, (b,)) > 0.9

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    q, c, qr, iq = NS_Q, NS_C51, NS_QR, NS_IQN
    return {
        "q": {"q": f(q["B"], q["N"]), "next_n_q": f(q["B"], q["N"]),
              "action": ints(q["N"], q["B"]),
              "next_n_action": ints(q["N"], q["B"]),
              "reward": f(q["nstep"], q["B"]), "done": done(q["B"])},
        "c51": {"dist": softmax(f(c["B"], c["N"], c["n_atom"])),
                "next_n_dist": softmax(f(c["B"], c["N"], c["n_atom"])),
                "act": ints(c["N"], c["B"]), "next_n_act": ints(c["N"], c["B"]),
                "reward": f(c["nstep"], c["B"]), "done": done(c["B"])},
        "qrdqn": {"q": f(qr["B"], qr["N"], qr["tau"]),
                  "next_n_q": f(qr["B"], qr["N"], qr["tau"]),
                  "action": ints(qr["N"], qr["B"]),
                  "next_n_action": ints(qr["N"], qr["B"]),
                  "reward": f(qr["nstep"], qr["B"]), "done": done(qr["B"]),
                  "tau": ((np.arange(qr["tau"]) + 0.5) / qr["tau"]).astype(
                      np.float32)},
        "iqn": {"q": f(iq["tau"], iq["B"], iq["N"]),
                "next_n_q": f(iq["tau_prime"], iq["B"], iq["N"]),
                "action": ints(iq["N"], iq["B"]),
                "next_n_action": ints(iq["N"], iq["B"]),
                "reward": f(iq["nstep"], iq["B"]), "done": done(iq["B"]),
                "replay_quantiles": rng.uniform(
                    0, 1, (iq["tau"], iq["B"])).astype(np.float32)}}


def nstep_op_calls(x) -> dict:
    """The five TD ops, each a callable that runs the op's forward and the
    backward of its loss into its q (or dist) and returns (loss, per-sample
    errors, gradient)."""
    def fwd_bwd(op, tuple_cls, inputs, grad_of, *args, **kwargs):
        def run():
            leaf = inputs[grad_of].detach().clone().requires_grad_(True)
            data = tuple_cls(**{**inputs, grad_of: leaf, "weight": None})
            loss, per = op(data, *args, **kwargs)
            loss.backward()
            return loss.detach(), per.detach(), leaf.grad
        return run

    q, c, qr, iq = NS_Q, NS_C51, NS_QR, NS_IQN
    return {
        "q_nstep_td_error": fwd_bwd(
            ops.q_nstep_td_error, ops.q_nstep_td_data, x["q"], "q",
            q["gamma"], q["nstep"]),
        "q_nstep_td_error_with_rescale": fwd_bwd(
            ops.q_nstep_td_error_with_rescale, ops.q_nstep_td_data, x["q"],
            "q", q["gamma"], q["nstep"]),
        "dist_nstep_td_error": fwd_bwd(
            ops.dist_nstep_td_error, ops.dist_nstep_td_data, x["c51"], "dist",
            c["gamma"], c["v_min"], c["v_max"], c["n_atom"], c["nstep"]),
        "qrdqn_nstep_td_error": fwd_bwd(
            ops.qrdqn_nstep_td_error, ops.qrdqn_nstep_td_data, x["qrdqn"],
            "q", qr["gamma"], qr["nstep"]),
        "iqn_nstep_td_error": fwd_bwd(
            ops.iqn_nstep_td_error, ops.iqn_nstep_td_data, x["iqn"], "q",
            iq["gamma"], iq["nstep"], iq["kappa"])}


def r2d2_arrays(rng, obs_dim, hidden, actions, layers, **_):
    """The example's init_params (:41-53) at its init scales, as numpy
    arrays: normal / sqrt(fan_in) embedding and Q head with zero biases, a
    uniform(-g, g) LN-LSTM with LN at identity."""
    n = lambda fan, *s: (rng.standard_normal(s) / np.sqrt(fan)
                         ).astype(np.float32)
    g = 1.0 / np.sqrt(hidden)
    u = lambda *s: rng.uniform(-g, g, s).astype(np.float32)
    ln = lambda v: np.full((layers, 4 * hidden), v, np.float32)
    lstm = origin.LSTMParams(
        tuple(u(hidden, 4 * hidden) for _ in range(layers)),
        tuple(u(hidden, 4 * hidden) for _ in range(layers)),
        u(layers, 4 * hidden), ln(1.0), ln(0.0), ln(1.0), ln(0.0))
    return models.R2D2Arrays(n(obs_dim, obs_dim, hidden),
                             np.zeros(hidden, np.float32), lstm,
                             n(hidden, hidden, actions),
                             np.zeros(actions, np.float32))


def r2d2_batches(rng, steps, S, B, obs_dim, hidden, actions, layers, **_):
    """Synthetic replay samples, one per step, as the example's train_step
    draws them (:68-78): obs (S+1, B, obs_dim), actions, rewards and dones
    (S, B), the stored LSTM state and unit importance weights."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return [{"obs": f(S + 1, B, obs_dim),
             "act": rng.integers(0, actions, (S, B)),
             "reward": 0.1 * f(S, B),
             "done": rng.uniform(0, 1, (S, B)) > 0.97,
             "stored_h": 0.1 * f(layers, B, hidden),
             "stored_c": 0.1 * f(layers, B, hidden),
             "weight": np.ones(B, np.float32)} for _ in range(steps)]


def r2d2_setup(arrays, batches_np, dev):
    """The online params on dev (Adam updates them in place), the frozen
    target params, their Adam and the batches, on dev."""
    p = models.from_jax_params(arrays, device=dev)
    target_p = models.from_jax_params(arrays, device=dev)
    lr = example_modules().r2d2.LR
    return (p, target_p, torch.optim.Adam(p.parameters(), lr=lr),
            [to_dev(b, dev) for b in batches_np])


def argmax_near_ties(q_card, q_cpu, act_card, act_cpu, gap=1e-4,
                     name="r2d2") -> int:
    """How many of the card's and the CPU's argmaxes differ; raises unless
    each such entry is a near tie on the CPU (its two picks within `gap`)."""
    q_cpu = q_cpu.detach()
    diff = act_card.cpu() != act_cpu
    if diff.any():
        picked = q_cpu.gather(-1, act_card.cpu()[..., None])[..., 0]
        if float((q_cpu.amax(dim=-1) - picked)[diff].max()) > gap:
            raise AssertionError(f"{name}: the card's argmax is not the "
                                 f"CPU's away from a tie")
    return int(diff.sum())


def phase_nstep(dev) -> dict:
    r2d2 = example_modules().r2d2
    rng = np.random.default_rng(SEED + 22)
    x_np = nstep_arrays(rng)
    r2_np = r2d2_arrays(rng, **R2D2_CFG)
    batches_np = r2d2_batches(rng, R2D2_STEPS, **R2D2_CFG)
    x = {k: to_dev(v, dev) for k, v in x_np.items()}
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    network.reset_route_counts()
    out = {name: run() for name, run in nstep_op_calls(x).items()}
    again = nstep_op_calls(x)["dist_nstep_td_error"]()
    p, target_p, opt, batches = r2d2_setup(r2_np, batches_np, dev)
    log, starts = [], []
    for batch in batches:
        starts.append((_cpu_copy(p.state_dict()),
                       copy.deepcopy(opt.state_dict())))
        log.append(r2d2.train_step(p, target_p, opt, batch, **R2D2_STEP))
        starts[-1] = (*starts[-1], _cpu_copy(p.state_dict()))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    routes = dict(network.lstm_fused.routes)
    check_launched("nstep", launches, NSTEP_KERNELS)
    # Five lstm_fused calls a step: two burn-ins, the two nets over the
    # sequence, the loss's forward.
    if routes != {"kernel": 5 * R2D2_STEPS * R2D2_CFG["layers"],
                  "recurrent": 0}:
        raise AssertionError(f"nstep: the layers' routes are {routes}, not "
                             f"the kernels")
    if not all(torch.equal(a, b) for a, b in
               zip(out["dist_nstep_td_error"], again)):
        raise AssertionError("dist_nstep_td_error: repeated runs differ")

    cpu = torch.device("cpu")
    ref = {name: run() for name, run in nstep_op_calls(
        {k: to_dev(v, cpu) for k, v in x_np.items()}).items()}
    result = {"launches": launches, "lstm_fused_routes": routes,
              "tolerance": {"rtol": RTOL, "atol": ATOL,
                            "grads_atol_rel_to_max": GRAD_ATOL_REL},
              "dist_nstep_bitwise_repeatable": True,
              "check_vs_cpu": {}, "r2d2_params_vs_cpu": {}}
    for name, (loss, per, grad) in out.items():
        r_loss, r_per, r_grad = ref[name]
        result["check_vs_cpu"][name] = {
            **compare(f"{name} loss and errors", [loss, per], [r_loss, r_per]),
            "grad": compare(f"{name} grad", [grad], [r_grad], atol=0.0,
                            atol_rel=GRAD_ATOL_REL)}
    # Each CPU step starts from the card's parameters and Adam state before
    # that step, and takes the card's double-DQN argmax (held against the
    # CPU's own up to near ties), as phase upgo holds the AlphaStar steps.
    ref_p, ref_target, ref_opt, ref_batches = r2d2_setup(r2_np, batches_np,
                                                         cpu)
    ties = 0
    for i, ((m, g, q_sel, next_act), (p_before, opt_before, p_after)) in \
            enumerate(zip(log, starts)):
        ref_p.load_state_dict(p_before)
        ref_opt.load_state_dict(opt_before)
        _, _, ref_q_sel = r2d2.targets(ref_p, ref_target, ref_batches[i],
                                       R2D2_CFG["burn_in"])
        compare(f"r2d2 step {i} q", [q_sel], [ref_q_sel])
        ties += argmax_near_ties(q_sel, ref_q_sel, next_act,
                                 ref_q_sel.argmax(dim=-1))
        rm, rg, _, _ = r2d2.train_step(ref_p, ref_target, ref_opt,
                                       ref_batches[i], **R2D2_STEP,
                                       next_act=next_act.cpu())
        result["check_vs_cpu"][f"r2d2 step {i}"] = compare(
            f"r2d2 step {i} loss and priorities", list(m.values()),
            list(rm.values()))
        for k in rg:
            compare(f"r2d2 step {i} grad {k}", [g[k]], [rg[k]], atol=0.0,
                    atol_rel=GRAD_ATOL_REL)
        result["r2d2_params_vs_cpu"][f"step {i}"] = check_adam_params(
            f"r2d2 step {i}", p_after, dict(ref_p.named_parameters()),
            [rg], r2d2.LR, 1)
    result["r2d2_argmax_near_ties"] = ties
    result["r2d2_losses"] = [float(m["loss"]) for m, *_ in log]
    result["r2d2_max_priority"] = [float(m["priorities"].max())
                                   for m, *_ in log]
    for name, fn in nstep_timed_calls(x, r2_np, batches_np, dev).items():
        result[f"ms_per_{name}"] = host_ms(fn, 7)
    return result


def nstep_timed_calls(x, r2_np, batches_np, dev, examples=True):
    """The end-to-end calls that are timed: each TD op's forward +
    backward at its NS_* shape and, with `examples`, one R2D2 train
    step."""
    calls = nstep_op_calls(x)
    shapes = {"q_nstep_td_error": "B64_N64",
              "q_nstep_td_error_with_rescale": "B64_N64",
              "dist_nstep_td_error": "B128_N128_atoms51",
              "qrdqn_nstep_td_error": "tau64_B4096_N64",
              "iqn_nstep_td_error": "tau33_B64_N8"}
    timed = {f"{name}_fwd_bwd_{shapes[name]}": calls[name] for name in calls}
    if examples:
        p, target_p, opt, batches = r2d2_setup(r2_np, batches_np[:1], dev)
        timed["r2d2_train_step_S20_B32"] = lambda: example_modules(
            ).r2d2.train_step(p, target_p, opt, batches[0], **R2D2_STEP)
    return timed


# ----------------------------------------------------------- phase 10 ----

# The C51 trainer of di_hpc_tpu_torch.examples.c51_training and the QR-DQN
# and IQN trainers of di_hpc_tpu_torch.examples.quantile_dqn_training in the
# JAX examples' configurations (main's defaults, examples/c51_training.py:
# 49-52 and examples/quantile_dqn_training.py:178-181), their Adam(1e-3) and
# their own batches.  Over REPLAY_STEPS steps every refresh rule of the JAX
# loops leaves the target net at the initial parameters.
C51_CFG = {"B": 128, "obs_dim": 32, "hidden": 64, "actions": 8,
           "n_atom": 51, "nstep": 3, "v_min": -10.0, "v_max": 10.0}
QDQN_CFG = {"B": 64, "obs_dim": 24, "hidden": 64, "actions": 8, "n_tau": 32,
            "n_tau_prime": 32, "n_cos": 64, "nstep": 3, "gamma": 0.99,
            "kappa": 1.0}
REPLAY_STEPS = 3
# Card against CPU for the replay steps' loss and per-sample TD errors.
REPLAY_RTOL, REPLAY_ATOL = 1e-4, 1e-5
# Each example's main() at its defaults, on the card: the kernels of the
# PPO (7), AlphaStar (1, 5, 2, 3, 11, 12) and R2D2 (1, 5) paths.
EXAMPLES_KERNELS = ("lstm_layer_fused", "lstm_layer_bwd_v1", "vtrace_losses",
                    "vtrace_returns_adv", "gae", "upgo_advantages",
                    "upgo_loss")


def replay_learners(ex) -> dict:
    """name -> (seed, Adam's lr, init(generator, device), draw(generator,
    device) of one batch, step(params, target, optimizer, batch,
    next_act=None)) of the three replay learners at their configurations."""
    c, q = C51_CFG, QDQN_CFG
    qd = ex.quantile
    return {
        "c51": (ex.c51.SEED, ex.c51.LR,
                lambda g, d: ex.c51.init_params(
                    g, c["obs_dim"], c["hidden"], c["actions"], c["n_atom"],
                    d),
                lambda g, d: ex.c51.synthetic_batch(
                    g, c["B"], c["obs_dim"], c["actions"], c["nstep"], d),
                lambda p, t, o, b, next_act=None: ex.c51.train_step(
                    p, t, o, b, c["n_atom"], c["nstep"], c["v_min"],
                    c["v_max"], next_act=next_act)),
        "qrdqn": (qd.QR_SEED, qd.LR,
                  lambda g, d: qd.init_qr(g, q["obs_dim"], q["hidden"],
                                          q["actions"], q["n_tau"], d),
                  lambda g, d: qd.synthetic_batch(
                      g, q["B"], q["obs_dim"], q["actions"], q["nstep"],
                      device=d),
                  lambda p, t, o, b, next_act=None: qd.qrdqn_step(
                      p, t, o, b, q["n_tau"], q["nstep"], q["gamma"],
                      next_act)),
        "iqn": (qd.IQN_SEED, qd.LR,
                lambda g, d: qd.init_iqn(g, q["obs_dim"], q["hidden"],
                                         q["actions"], q["n_cos"], d),
                lambda g, d: qd.synthetic_batch(
                    g, q["B"], q["obs_dim"], q["actions"], q["nstep"],
                    q["n_tau"], q["n_tau_prime"], d),
                lambda p, t, o, b, next_act=None: qd.iqn_step(
                    p, t, o, b, q["n_cos"], q["nstep"], q["gamma"],
                    q["kappa"], next_act))}


def replay_leg(name, seed, lr, init, draw, step, dev) -> dict:
    """REPLAY_STEPS steps of one learner on the card, then each held
    against the same step on the CPU started from the card's parameters and
    Adam state before it and given the card's next action (held against
    the CPU's own argmax up to near ties): the loss and TD errors, every
    gradient, the updated parameters.  Returns the checks, the steps'
    losses and the host ms per card step (median of 7)."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    start = init(gen, cpu)
    batches = [draw(gen, cpu) for _ in range(REPLAY_STEPS)]
    p, target = copy.deepcopy(start).to(dev), copy.deepcopy(start).to(dev)
    opt = torch.optim.Adam(p.parameters(), lr=lr)
    log, starts = [], []
    for b in batches:
        starts.append((_cpu_copy(p.state_dict()),
                       copy.deepcopy(opt.state_dict())))
        log.append(step(p, target, opt, {k: v.to(dev) for k, v in b.items()}))
        starts[-1] = (*starts[-1], _cpu_copy(p.state_dict()))
    torch.cuda.synchronize()

    ref_p, ref_target = copy.deepcopy(start), copy.deepcopy(start)
    ref_opt = torch.optim.Adam(ref_p.parameters(), lr=lr)
    out = {"check_vs_cpu": {}, "params_vs_cpu": {}, "argmax_near_ties": 0}
    for i, ((m, g, next_q, next_act), (p_before, opt_before, p_after)) in \
            enumerate(zip(log, starts)):
        ref_p.load_state_dict(p_before)
        ref_opt.load_state_dict(opt_before)
        rm, rg, ref_q, _ = step(ref_p, ref_target, ref_opt, batches[i],
                                next_act.cpu())
        out["argmax_near_ties"] += argmax_near_ties(
            next_q, ref_q, next_act, ref_q.argmax(dim=-1), name=name)
        out["check_vs_cpu"][f"step {i}"] = {
            **compare(f"{name} step {i} loss and td", list(m.values()),
                      list(rm.values()), rtol=REPLAY_RTOL, atol=REPLAY_ATOL),
            "grads": {k: compare(f"{name} step {i} grad {k}", [g[k]],
                                 [rg[k]], atol=0.0, atol_rel=GRAD_ATOL_REL)
                      for k in rg}}
        out["params_vs_cpu"][f"step {i}"] = check_adam_params(
            f"{name} step {i}", p_after, dict(ref_p.named_parameters()),
            [rg], lr, 1)
    out["losses"] = [float(m["loss"]) for m, *_ in log]
    first = {k: v.to(dev) for k, v in batches[0].items()}
    out[f"ms_per_{name}_step"] = host_ms(
        lambda: step(p, target, opt, first), 7)
    return out


def run_example_mains(ex, dev) -> dict:
    """Each example's main() once on the card at its defaults, its printout
    kept (the losses of its last step among them): seconds and finite
    parameters."""
    mains = {"c51_training": ex.c51.main,
             "quantile_dqn_training": ex.quantile.main,
             "ppo_training": ex.ppo.main,
             "alphastar_policy_training": ex.alphastar.main,
             "r2d2_training": ex.r2d2.main}
    out = {}
    for name, main_fn in mains.items():
        printed = io.StringIO()
        start = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            params = main_fn(device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        nets = params.values() if isinstance(params, dict) else [params]
        check_finite(f"{name}.main() parameters",
                     [t for net in nets for t in net.parameters()])
        out[name] = {"seconds": seconds,
                     "printed": printed.getvalue().splitlines()}
    return out


def phase_replay(dev) -> dict:
    ex = example_modules()
    kernels.reset_launch_counts()
    learners = {name: replay_leg(name, *spec, dev)
                for name, spec in replay_learners(ex).items()}
    launches = kernels.launch_counts()
    # The replay learners' ops are plain PyTorch in both packages.
    if any(launches.values()):
        raise AssertionError(f"replay: a kernel launched on a path that has "
                             f"none: {launches}")
    result = {"launches": launches, "no_kernel_on_this_path": True,
              "tolerance": {"loss_td": {"rtol": REPLAY_RTOL,
                                        "atol": REPLAY_ATOL},
                            "grads_atol_rel_to_max": GRAD_ATOL_REL},
              **learners}

    kernels.reset_launch_counts()
    network.reset_route_counts()
    mains = run_example_mains(ex, dev)
    launches = kernels.launch_counts()
    check_launched("examples", launches, EXAMPLES_KERNELS)
    routes = dict(network.lstm_fused.routes)
    if routes["recurrent"]:
        raise AssertionError(f"examples: the layers' routes are {routes}, "
                             f"not the kernels")
    result["examples"] = {"launches": launches, "lstm_fused_routes": routes,
                          **mains}
    return result


# ----------------------------------------------------------- phase 11 ----

# Ragged padding at the JAX bench's reference configuration
# (bench.py:890-903): B=64 float32 items per rank, each extent drawn from
# these ranges; each ungrouped, grouped by the oracle DP and by sampled
# pivots (group 4).
PAD_B = 64
PAD_RANGES = {1: ((32, 128),), 2: ((48, 80), (32, 64)),
              3: ((24, 32), (24, 32), (32, 40))}
PAD_MODES = {"": {}, "_grp4": {"group": 4, "group_mode": "oracle"},
             "_sample4": {"group": 4, "group_mode": "sample"}}
# The actor-learner's batch: T=16, B=32 trajectories of the example's
# fields, plus one ragged float32 and one ragged int32 field.
DATA_T, DATA_B = 16, 32
# The episodic A2C (examples/episodic_a2c_padding.py, its configuration)
# and the actor-learner (examples/impala_actor_learner.py) runs.
EPISODIC_CFG = {"n_eps": 48, "obs_dim": 16, "hidden": 64, "actions": 6,
                "l_min": 8, "l_max": 64, "group": 3, "gamma": 0.99,
                "lambda_": 0.95}
EPISODIC_STEPS, EPISODIC_LR = 3, 1e-3
LEARNER_STEPS = 6
HOSTDATA_KERNELS = ("lstm_layer_fused", "vtrace_losses",
                    "vtrace_returns_adv", "lstm_layer_bwd_v1",
                    "lambda_returns", "linear_scan")
# bench_fn on ops.gae at the north-star plane.
BENCH_T, BENCH_B = 1024, 4096


def hostdata_modules() -> SimpleNamespace:
    """The host data plane, utils, entry and examples of the port, imported
    here and not at the top, so that --digests and --profile still run in
    an older checkout that lacks them."""
    from di_hpc_tpu_torch import data, entry, utils
    from di_hpc_tpu_torch.examples import (
        episodic_a2c_padding, impala_actor_learner)
    from di_hpc_tpu_torch.utils import checkpoint
    return SimpleNamespace(data=data, entry=entry, utils=utils,
                           checkpoint=checkpoint,
                           episodic=episodic_a2c_padding,
                           learner=impala_actor_learner)


def bitwise_equal(got, want) -> bool:
    """Same dtype, shape and bits (after moving both to the host)."""
    got, want = got.detach().cpu(), want.detach().cpu()
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.reshape(-1).view(torch.uint8),
                            want.reshape(-1).view(torch.uint8)))


def check_padded(name, got, want, group) -> None:
    """Two results of a Padding call (tensors, masks, shapes; per bucket
    when grouped) are equal bit for bit."""
    if group == 1:
        got, want = [[g] for g in got], [[w] for w in want]
    if len(got[0]) != len(want[0]):
        raise AssertionError(f"{name}: {len(got[0])} buckets, not "
                             f"{len(want[0])}")
    for gp, gm, gs, wp, wm, ws in zip(*got, *want):
        if not (bitwise_equal(gp, wp) and bitwise_equal(gm, wm)
                and list(gs) == list(ws)):
            raise AssertionError(f"{name}: batch, mask or shapes differ")


def padding_inputs(rng) -> dict:
    return {ndim: [rng.standard_normal(tuple(int(rng.integers(lo, hi))
                                             for lo, hi in ranges),
                                       dtype=np.float32)
                   for _ in range(PAD_B)]
            for ndim, ranges in PAD_RANGES.items()}


def padding_leg(ndim, xs, kw, dev) -> dict:
    """One Padding call three ways -- numpy inputs to the CPU and to the
    card, CUDA inputs packed on the card -- bitwise against each other,
    UnPadding back to every input, then host-clock medians: bucketing +
    pack (device="cpu"), the transfer of its result, the whole call to the
    card, the call on CUDA inputs, and the oracle (origin) to the card."""
    unpad = getattr(ops, f"UnPadding{ndim}D")
    group = kw.get("group", 1)

    def call(items, device, mod=ops):
        extra = ({"rng": np.random.default_rng(SEED)}
                 if kw.get("group_mode") == "sample" else {})
        return getattr(mod, f"Padding{ndim}D")(list(items), device=device,
                                               **kw, **extra)

    on_card = [torch.from_numpy(a).to(dev) for a in xs]
    torch.cuda.synchronize()
    want = call(xs, "cpu")
    check_padded(f"pad{ndim}d{kw} numpy->cuda", call(xs, dev), want, group)
    got = call(on_card, dev)
    check_padded(f"pad{ndim}d{kw} cuda->cuda", got, want, group)
    padded, shapes = (list(got[0]), list(got[2])) if group > 1 else \
        (got[0], got[2])
    order = sorted(range(len(xs)), key=lambda i: xs[i].size) \
        if group > 1 else range(len(xs))
    back = unpad(padded, shapes)
    if not all(bitwise_equal(b, torch.from_numpy(xs[i]))
               for b, i in zip(back, order)) or len(back) != len(xs):
        raise AssertionError(f"pad{ndim}d{kw}: UnPadding does not give back "
                             f"the inputs")
    batches = [want[0]] if group == 1 else list(want[0])
    tensors = batches + ([want[1]] if group == 1 else list(want[1]))
    pad_elems = sum(t.numel() for t in batches)
    return {"buckets": len(got[0]) if group > 1 else 1,
            "padded_elems": pad_elems,
            "pad_share": 1 - sum(a.size for a in xs) / pad_elems,
            "bucket_pack_ms": host_ms(lambda: call(xs, "cpu"), 7),
            "transfer_ms": host_ms(lambda: [t.to(dev) for t in tensors], 7),
            "to_card_ms": host_ms(lambda: call(xs, dev), 7),
            "card_inputs_ms": host_ms(lambda: call(on_card, dev), 7),
            "origin_to_card_ms": host_ms(lambda: call(xs, dev, origin), 7)}


def data_trajectories(rng) -> list:
    """The actor-learner's trajectories (obs, action, reward, behaviour
    logits at obs 16, 4 actions) with a ragged float32 and int32 field."""
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    out = []
    for _ in range(2 * DATA_B):
        L = int(rng.integers(DATA_T // 2, DATA_T + 1))
        out.append({"obs": f(DATA_T + 1, 16),
                    "action": rng.integers(0, 4, DATA_T),
                    "reward": f(DATA_T),
                    "behaviour_logits": f(DATA_T, 4),
                    "ragged_f32": f(L, 3),
                    "ragged_i32": rng.integers(0, 9, L).astype(np.int32)})
    return out


def data_leg(rng, dev) -> dict:
    """stack_trajectories and TrajectoryBuffer.sample_batch (FIFO and
    replay) on the card against the CPU, bitwise; host-clock medians."""
    data = hostdata_modules().data
    trajs = data_trajectories(rng)
    buffers = {}
    for device in (dev, "cpu"):
        buf = data.TrajectoryBuffer(capacity=4 * DATA_B)
        for t in trajs:
            buf.add(t)
        buffers[device] = buf
    out = {}
    for kw in ({"pop": True}, {"pop": False}):
        batches = {device: buf.sample_batch(
            DATA_B, rng=np.random.default_rng(SEED), timeout=1.0,
            device=device, **kw) for device, buf in buffers.items()}
        card, cpu = batches[dev], batches["cpu"]
        if list(card) != list(cpu) or not all(
                bitwise_equal(card[k], cpu[k]) for k in cpu):
            raise AssertionError(f"sample_batch {kw}: the card's batch is "
                                 f"not the CPU's")
        if card["ragged_f32_mask"].dtype != torch.bool or \
                card["ragged_i32"].dtype != torch.int32 or \
                card["action"].dtype != torch.int32:
            raise AssertionError("sample_batch: dtypes not JAX's")
        out["fields"] = {k: [str(v.dtype), list(v.shape)]
                         for k, v in card.items()}
    out["64_bit"] = data_leg_64_bit(data, trajs, dev)
    buf = buffers[dev]
    out["stack_ms"] = host_ms(
        lambda: data.stack_trajectories(trajs[:DATA_B]), 7)
    out["sample_batch_replay_ms"] = host_ms(lambda: buf.sample_batch(
        DATA_B, pop=False, rng=np.random.default_rng(SEED), device=dev), 7)
    return out


def data_leg_64_bit(data, trajs, dev) -> dict:
    """The trajectories with float64 fields and int64 actions: the card's
    batch arrives float32 and int32, as JAX's transfer gives it, and
    ops.vtrace_error on it (target logits = behaviour logits + 0.1, value
    = obs[..., 0]) with its gradient launches kernels 2 and 3, counted on
    their own."""
    buf = data.TrajectoryBuffer(capacity=DATA_B)
    for t in trajs[:DATA_B]:
        buf.add({k: v.astype(np.float64) if v.dtype == np.float32
                 else v.astype(np.int64) for k, v in t.items()})
    batch = buf.sample_batch(DATA_B, timeout=1.0, device=dev)
    dtypes = {k: str(v.dtype) for k, v in batch.items()}
    want = {k: "torch.bool" if k.endswith("_mask") else "torch.int32"
            if k in ("action", "ragged_i32") else "torch.float32"
            for k in batch}
    if dtypes != want:
        raise AssertionError(f"64-bit sample_batch: dtypes {dtypes}, not "
                             f"JAX's {want}")
    target = (batch["behaviour_logits"] + 0.1).requires_grad_()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    losses = ops.vtrace_error(ops.vtrace_data(
        target, batch["behaviour_logits"], batch["action"],
        batch["obs"][..., 0], batch["reward"], None))
    (losses.policy_loss + losses.value_loss).backward()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launched("64-bit sample_batch -> ops.vtrace_error", launches,
                   ("vtrace_losses", "vtrace_returns_adv"))
    return {"dtypes": dtypes,
            "vtrace_launches": {n: launches[n] for n in (
                "vtrace_losses", "vtrace_returns_adv")}}


def episodic_setup(dev):
    p = hostdata_modules().episodic.init_params(torch.Generator().manual_seed(SEED),
                             EPISODIC_CFG["obs_dim"], EPISODIC_CFG["hidden"],
                             EPISODIC_CFG["actions"], dev)
    return p, torch.optim.Adam(p.parameters(), lr=EPISODIC_LR)


def episodic_episodes(rng, steps) -> list:
    c = EPISODIC_CFG
    return [hostdata_modules().episodic.make_episodes(rng, c["n_eps"], c["obs_dim"],
                                   c["actions"], c["l_min"], c["l_max"])
            for _ in range(steps)]


def episodic_step(p, opt, episodes, dev):
    c = EPISODIC_CFG
    return hostdata_modules().episodic.train_step(p, opt, episodes, c["group"], c["gamma"],
                               c["lambda_"], dev)


def phase_hostdata(dev, kernel_rows) -> dict:
    m = hostdata_modules()
    rng = np.random.default_rng(SEED + 24)
    result = {"padding": {}}
    for ndim, xs in padding_inputs(rng).items():
        for tag, kw in PAD_MODES.items():
            result["padding"][f"pad{ndim}d{tag}"] = padding_leg(ndim, xs, kw,
                                                                dev)
    result["data"] = data_leg(rng, dev)
    episodes = episodic_episodes(rng, EPISODIC_STEPS)
    fwd, (e_params, e_obs) = m.entry.entry(device=dev)
    step0, losses, stamps = {}, [], []

    def on_step(i, params, batch, metrics):
        stamps.append(time.perf_counter())
        if i == 0:
            step0.update(
                batch=models.TrainBatch(*(t.cpu() for t in batch)),
                metrics={k: v.cpu() for k, v in metrics.items()},
                grads={k: q.grad.cpu() for k, q in params.named_parameters()},
                after=_cpu_copy(dict(params.named_parameters())))
        losses.append({k: float(v) for k, v in metrics.items()})

    # The counted run: entry's forward, the episodic steps, the learner.
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        e_out = fwd(e_params, e_obs)
    p, opt = episodic_setup(dev)
    ep_log, starts = [], []
    for eps in episodes:
        starts.append((_cpu_copy(p.state_dict()),
                       copy.deepcopy(opt.state_dict())))
        ep_log.append(episodic_step(p, opt, eps, dev))
        starts[-1] = (*starts[-1], _cpu_copy(p.state_dict()))
    ep_launches = kernels.launch_counts()
    learner_params = m.learner.run(
        steps=LEARNER_STEPS, device=dev, on_step=on_step)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    check_launched("hostdata", launches, HOSTDATA_KERNELS)
    buckets = sum(len(sizes) for _, _, sizes in ep_log)
    for name in ("lambda_returns", "linear_scan"):
        if ep_launches[name] != buckets:
            raise AssertionError(f"episodic: {name} launched "
                                 f"{ep_launches[name]} times for {buckets} "
                                 f"buckets")
    result.update({"launches": launches,
                   "episodic_launches": ep_launches,
                   "tolerance": {"rtol": RTOL, "atol": ATOL,
                                 "grads_atol_rel_to_max": GRAD_ATOL_REL},
                   "check_vs_cpu": {}})

    cpu = torch.device("cpu")
    c_fwd, (c_params, c_obs) = m.entry.entry(device=cpu)
    with torch.no_grad():
        result["check_vs_cpu"]["entry forward"] = compare(
            "entry forward", e_out, c_fwd(c_params, c_obs))

    # Each CPU episodic step starts from the card's parameters and Adam
    # state before that step, as phase upgo holds the AlphaStar steps.
    ref_p, ref_opt = episodic_setup(cpu)
    result["episodic_params_vs_cpu"] = {}
    for i, ((loss, grads, sizes), (p_before, opt_before, p_after)) in \
            enumerate(zip(ep_log, starts)):
        ref_p.load_state_dict(p_before)
        ref_opt.load_state_dict(opt_before)
        r_loss, r_grads, r_sizes = episodic_step(ref_p, ref_opt,
                                                 episodes[i], cpu)
        if sizes != r_sizes:
            raise AssertionError(f"episodic step {i}: buckets {sizes} vs "
                                 f"{r_sizes}")
        result["check_vs_cpu"][f"episodic step {i}"] = compare(
            f"episodic step {i} loss", [torch.tensor(loss)],
            [torch.tensor(r_loss)])
        for k in r_grads:
            compare(f"episodic step {i} grad {k}", [grads[k]], [r_grads[k]],
                    atol=0.0, atol_rel=GRAD_ATOL_REL)
        result["episodic_params_vs_cpu"][f"step {i}"] = check_adam_params(
            f"episodic step {i}", p_after, dict(ref_p.named_parameters()),
            [r_grads], EPISODIC_LR, 1)
    result["episodic_steps"] = [{"loss": loss, "buckets_TxB": sizes}
                                for loss, _, sizes in ep_log]

    # The learner's step 0 on the CPU, from the same initial parameters.
    ref_params, _, ref_train = m.learner.init_learner(cpu)
    ref_metrics = ref_train(ref_params, step0["batch"])
    result["check_vs_cpu"]["learner step 0"] = compare(
        "learner step 0 metrics", list(step0["metrics"].values()),
        list(ref_metrics.values()))
    ref_grads = {k: q.grad for k, q in ref_params.named_parameters()}
    for k in ref_grads:
        compare(f"learner step 0 grad {k}", [step0["grads"][k]],
                [ref_grads[k]], atol=0.0, atol_rel=GRAD_ATOL_REL)
    result["learner_params_vs_cpu"] = check_adam_params(
        "learner step 0", step0["after"],
        dict(ref_params.named_parameters()), [ref_grads], m.learner.LR, 1)
    if len(losses) != LEARNER_STEPS or not all(
            np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"learner: losses {losses}")
    result["learner_steps"] = losses
    result["learner_layer_route"] = network.layer_route(
        DATA_B, m.learner.CFG.hidden_size, torch.float32, True,
        torch.cuda.get_device_properties(dev).shared_memory_per_block_optin)
    result["ms_per_learner_loop_step"] = statistics.median(
        (b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))

    # The timed calls: a learner train step on step 0's batch (its Adam
    # state also goes through the checkpoint), an episodic step.
    params, opt, train = m.learner.init_learner(dev)
    batch = models.TrainBatch(*(t.to(dev) for t in step0["batch"]))
    result["ms_per_learner_step_T16_B32"] = host_ms(
        lambda: train(params, batch), 7)
    p, opt_e = episodic_setup(dev)
    result["ms_per_episodic_step"] = host_ms(
        lambda: episodic_step(p, opt_e, episodes[0], dev), 7)

    # Checkpoint round trip of the card's parameters and Adam state.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "learner")
        tree = {"params": params, "adam": opt.state_dict(),
                "actor_learner_params": learner_params}
        m.utils.save_pytree(path, tree)
        like = {"params": m.learner.init_learner(dev)[0],
                "adam": opt.state_dict(),
                "actor_learner_params": m.learner.init_learner(dev)[0]}
        loaded = m.utils.load_pytree(path, like)
    got, _ = m.checkpoint.tree_flatten(loaded)
    want, _ = m.checkpoint.tree_flatten(tree)
    if len(got) != len(want) or not all(
            bitwise_equal(g, w) and g.device == w.device
            if isinstance(w, torch.Tensor) else g == w
            for g, w in zip(got, want)):
        raise AssertionError("checkpoint: the loaded tree differs")
    result["checkpoint_leaves"] = len(got)

    # bench_fn and roofline on ops.gae, beside phase kernels' GAE row.
    value = torch.from_numpy(rng.standard_normal(
        (BENCH_T + 1, BENCH_B), dtype=np.float32)).to(dev)
    reward = torch.from_numpy(rng.standard_normal(
        (BENCH_T, BENCH_B), dtype=np.float32)).to(dev)
    seconds = m.utils.bench_fn(lambda v, r: ops.gae(ops.gae_data(v, r)),
                               value, reward)
    nbytes = scan_bounds(BENCH_T, BENCH_B)["gae"][0]
    roof = m.utils.roofline(seconds, nbytes)
    row = kernel_rows.get("gae T=1024", {})
    result["bench_fn_gae_T1024_B4096"] = {
        "ms": seconds * 1e3, "roofline": str(roof),
        "sol_fraction": roof.sol_fraction,
        "kernels_row_ms_cold": row.get("ms"),
        "kernels_row_ms_l2_warm": row.get("ms_l2_warm")}
    return result


def hostdata_timed_calls(dev):
    """The two end-to-end calls of phase hostdata that are profiled: one
    episodic A2C step and one learner train step, on inputs of their own."""
    rng = np.random.default_rng(SEED + 25)
    episodes = episodic_episodes(rng, 1)[0]
    p, opt = episodic_setup(dev)
    params, _, train = hostdata_modules().learner.init_learner(dev)
    f = lambda *s: torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(dev)
    batch = models.TrainBatch(
        f(DATA_T + 1, DATA_B, 16),
        torch.from_numpy(rng.integers(0, 4, (DATA_T, DATA_B))).to(dev),
        f(DATA_T, DATA_B), f(DATA_T, DATA_B, 4))
    return {"episodic_a2c_step": lambda: episodic_step(p, opt, episodes,
                                                       dev),
            "learner_step_T16_B32": lambda: train(params, batch)}


# ----------------------------------------------------------- phase 12 ----

# A gloo world of 4 processes on the one card, each on cuda:0 (NCCL refuses
# two ranks on one card), at the full width of phase kernels' V-trace and
# scan rows.
PAR_WORLD = 4
PAR_T, PAR_B, PAR_N = 1024, 4096, 32
PAR_MESHES = {"data4": {"data": 4}, "time4": {"time": 4},
              "time2xdata2": {"time": 2, "data": 2}}
# The axes each mesh's scans shard time and batch over: the data mesh's one
# axis takes time.
PAR_SCAN_AXES = {"data4": ("data", None), "time4": ("time", None),
                 "time2xdata2": ("time", "data")}
# tests/test_parallel.py's PPO and n-step TD shapes, at B=4096.
PAR_PPO = {"B": 4096, "N": 10, "nstep": 3}
PAR_KERNELS = ("linear_scan", "vtrace_losses", "vtrace_returns_adv")
# The calls whose second tensor is a gradient in the (T, B, N) target
# logits, with the (time, batch) shards of their mesh.  A gradient entry is
# about |adv| / (T * B), far below ATOL, so each (time, batch) block is held
# at PAR_GRAD_REL of its own max|want| and must not be all zeros: a
# gradient right in rank 0's rows only, or zero, fails.
PAR_GRADS = {"vtrace_error_time_sharded": (2, 2),
             "data_parallel(ops.vtrace_error)": (1, 4)}
PAR_GRAD_REL = 1e-5
PAR_REPS = 5
PAR_TAG = "PARALLEL_RANK "
# A world that has not finished by then is killed and the phase fails.
PAR_TIMEOUT_S = 480


def spawn_world(argv, world, timeout, env=None) -> list:
    """parallel.runtime.spawn_world (imported here, not at the top, so that
    --digests and --profile still run in an older checkout that lacks
    it)."""
    from di_hpc_tpu_torch.parallel.runtime import spawn_world as spawn

    return spawn(argv, world, timeout, env)


def parallel_inputs(dev) -> dict:
    """The phase's global tensors, made on the card from one seed: the same
    bits on every rank."""
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    n = lambda *s: torch.randn(s, generator=g, device=dev)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(s, generator=g,
                                                      device=dev)
    i = lambda k, *s: torch.randint(0, k, s, generator=g, device=dev)
    T, B, N = PAR_T, PAR_B, PAR_N
    Bp, Np = PAR_PPO["B"], PAR_PPO["N"]
    return {"a": n(T, B), "b": u(-0.99, 0.99, T, B), "value": n(T + 1, B),
            "reward": n(T, B), "weight": u(0.3, 2.0, B), "to": n(T, B, N),
            "bo": n(T, B, N), "act": i(N, T, B),
            "rhos": torch.exp(0.2 * n(T, B)),
            "ln": n(Bp, Np), "lo": n(Bp, Np), "pact": i(Np, Bp),
            "vn": n(Bp), "vo": n(Bp), "adv": n(Bp), "ret": n(Bp),
            "q": n(Bp, Np), "nq": n(Bp, Np), "qrew": n(PAR_PPO["nstep"], Bp),
            "done": (u(0.0, 1.0, Bp) > 0.5).float()}


def vtrace_with_grad(fn, x, total: bool) -> tuple:
    """fn's V-trace losses on x and the gradient in the target logits of
    the policy loss (+ the value loss when `total`)."""
    to = x["to"].detach().requires_grad_()
    losses = fn(ops.vtrace_data(to, x["bo"], x["act"], x["value"],
                                x["reward"], None))
    loss = losses.policy_loss + (losses.value_loss if total else 0.0)
    (grad,) = torch.autograd.grad(loss, to)
    return torch.stack(tuple(losses)).detach(), grad


def parallel_calls(P, x, meshes) -> dict:
    """name -> (the sharded call, the unsharded op), each giving a tuple of
    tensors."""
    calls = {}
    for tag, mesh in meshes.items():
        t_ax, b_ax = PAR_SCAN_AXES[tag]
        for way, sharded, plain in (
                ("reverse", P.linear_recurrence_reverse_sharded,
                 ops.linear_recurrence_reverse),
                ("forward", P.linear_recurrence_forward_sharded,
                 ops.linear_recurrence_forward)):
            calls[f"linear_recurrence_{way}_sharded {tag}"] = (
                lambda s=sharded, m=mesh, t=t_ax, b=b_ax: (s(
                    x["a"], x["b"], m, time_axis=t, batch_axis=b),),
                lambda p=plain: (p(x["a"], x["b"]),))
    m, kw = meshes["time2xdata2"], {"batch_axis": "data"}
    v, r, w = x["value"], x["reward"], x["weight"]
    calls.update({
        "gae_time_sharded": (
            lambda: (P.gae_time_sharded(v, r, m, **kw),),
            lambda: (ops.gae(ops.gae_data(v, r)),)),
        "lambda_returns_time_sharded": (
            lambda: (P.lambda_returns_time_sharded(v, r, m, 0.9, 0.8, **kw),),
            lambda: (ops.generalized_lambda_returns(v, r, 0.9, 0.8),)),
        "td_lambda_error_time_sharded": (
            lambda: (P.td_lambda_error_time_sharded(v, r, None, m, **kw),),
            lambda: (ops.td_lambda_error(ops.td_lambda_data(v, r, None)),)),
        "td_lambda_error_time_sharded weighted": (
            lambda: (P.td_lambda_error_time_sharded(v, r, w, m, **kw),),
            lambda: (ops.td_lambda_error(ops.td_lambda_data(v, r, w)),)),
        "upgo_loss_time_sharded": (
            lambda: (P.upgo_loss_time_sharded(x["to"], x["rhos"], x["act"],
                                              r, v, m, **kw),),
            lambda: (ops.upgo_loss(x["to"], x["rhos"], x["act"], r, v),)),
        "vtrace_error_time_sharded": (
            lambda: vtrace_with_grad(
                lambda d: P.vtrace_error_time_sharded(d, m, **kw), x, False),
            lambda: vtrace_with_grad(ops.vtrace_error, x, False))})
    dm = meshes["data4"]
    dp_vtrace = P.data_parallel(ops.vtrace_error, dm,
                                ops.vtrace_data(1, 1, 1, 1, 1, None))
    dp_ppo = P.data_parallel(ops.ppo_error, dm,
                             ops.ppo_data(0, 0, 0, 0, 0, 0, 0, None))
    dp_td = P.data_parallel(ops.q_nstep_td_error, dm,
                            ops.q_nstep_td_data(0, 0, 0, 0, 1, 0, None))
    ppo = ops.ppo_data(x["ln"], x["lo"], x["pact"], x["vn"], x["vo"],
                       x["adv"], x["ret"], None)
    td = ops.q_nstep_td_data(x["q"], x["nq"], x["pact"], x["pact"],
                             x["qrew"], x["done"], None)
    flat = lambda out: tuple(t for part in out for t in part)
    calls.update({
        "data_parallel(ops.vtrace_error)": (
            lambda: vtrace_with_grad(dp_vtrace, x, True),
            lambda: vtrace_with_grad(ops.vtrace_error, x, True)),
        "data_parallel(ops.ppo_error)": (
            lambda: flat(dp_ppo(ppo)), lambda: flat(ops.ppo_error(ppo))),
        "data_parallel(ops.q_nstep_td_error)": (
            lambda: tuple(dp_td(td, 0.95, PAR_PPO["nstep"])),
            lambda: tuple(ops.q_nstep_td_error(td, 0.95, PAR_PPO["nstep"])))})
    return calls


def compare_grad_blocks(name, got, want, t_shards: int, b_shards: int
                        ) -> dict:
    """got against want block by block over `t_shards` x `b_shards` blocks
    of dims 0 and 1, each at RTOL and PAR_GRAD_REL of the block's own
    max|want|, no block all zeros; the worst block's errors."""
    worst = None
    for i, (g_t, w_t) in enumerate(zip(got.chunk(t_shards, 0),
                                       want.chunk(t_shards, 0))):
        for j, (g, w) in enumerate(zip(g_t.chunk(b_shards, 1),
                                       w_t.chunk(b_shards, 1))):
            block = f"{name} block ({i}, {j})"
            if not bool(g.ne(0).any()):
                raise AssertionError(f"{block}: all zeros")
            c = compare(block, (g,), (w,), atol=0.0, atol_rel=PAR_GRAD_REL)
            if worst is None or c["max_err_over_max"] > \
                    worst["max_err_over_max"]:
                worst = c
    return worst


def parallel_checks(got, want) -> dict:
    """Each sharded call against the unsharded op: the outputs at
    RTOL/ATOL, and a gradient (PAR_GRADS) block by block."""
    checks = {}
    for name in want:
        if name in PAR_GRADS:
            checks[name] = compare(name, got[name][:1], want[name][:1])
            checks[name + " grad"] = compare_grad_blocks(
                name + " grad", got[name][1], want[name][1],
                *PAR_GRADS[name])
        else:
            checks[name] = compare(name, got[name], want[name])
    return checks


def parallel_worker(workdir, rank: int, world: int) -> int:
    """One rank of phase parallel: the unsharded ops, then every sharded
    call once with the launch counts set to 0 just before and read just
    after, each against the unsharded op; then host-clock medians of both.
    Prints one line, PAR_TAG and a JSON object."""
    import torch.distributed as dist

    from di_hpc_tpu_torch import parallel as P

    P.initialize(f"file://{os.path.join(workdir, 'store')}", world, rank)
    meshes = {tag: P.make_mesh(sizes) for tag, sizes in PAR_MESHES.items()}
    dev = meshes["data4"].device
    x = parallel_inputs(dev)
    calls = parallel_calls(P, x, meshes)
    want = {name: plain() for name, (_, plain) in calls.items()}
    torch.cuda.synchronize()
    dist.barrier()
    kernels.reset_launch_counts()
    got = {name: sharded() for name, (sharded, _) in calls.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    checks = parallel_checks(got, want)
    ms = {name: {"sharded": host_ms(sharded, PAR_REPS),
                 "unsharded": host_ms(plain, PAR_REPS)}
          for name, (sharded, plain) in calls.items()}
    print(PAR_TAG + json.dumps({
        "rank": rank, "backend": dist.get_backend(), "device": str(dev),
        "meshes": {tag: m.shape for tag, m in meshes.items()},
        "launches": launches, "checks": checks, "ms": ms,
        "digests": {name: sha256(out) for name, out in got.items()}}),
        flush=True)
    dist.destroy_process_group()
    return 0


def phase_parallel(dev) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        outs = spawn_world([os.path.abspath(__file__), "--parallel-worker",
                            tmp], PAR_WORLD, PAR_TIMEOUT_S)
    reports = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith(PAR_TAG))[len(PAR_TAG):])
               for out in outs]
    first = reports[0]
    for rep in reports[1:]:
        differ = [n for n in first["digests"]
                  if rep["digests"][n] != first["digests"][n]]
        if differ:
            raise AssertionError(f"rank {rep['rank']}: results differ from "
                                 f"rank 0's bits: {differ}")
    launches = {name: sum(rep["launches"][name] for rep in reports)
                for name in first["launches"]}
    check_launched("parallel", launches, PAR_KERNELS)
    shared = first["backend"] == "gloo"
    return {"world": PAR_WORLD, "backend": first["backend"],
            "devices": [rep["device"] for rep in reports],
            "meshes": first["meshes"],
            "shape": {"T": PAR_T, "B": PAR_B, "N": PAR_N, "ppo_td": PAR_PPO},
            "launches": launches,
            "launches_by_rank": [{n: rep["launches"][n] for n in PAR_KERNELS}
                                 for rep in reports],
            "bitwise_equal_ranks": len(reports),
            "tolerance": {"rtol": RTOL, "atol": ATOL,
                          "gradient_blocks": {"rtol": RTOL, "atol": 0.0,
                                              "atol_rel": PAR_GRAD_REL}},
            "check_vs_unsharded": {
                name: max((rep["checks"][name] for rep in reports),
                          key=lambda c: c["max_err_over_max"])
                for name in first["checks"]},
            "timing_note": (
                f"host-clock medians of rank 0 over {PAR_REPS} calls; " + (
                    "four processes share one card and stage every "
                    "collective through the host (gloo), so these are not "
                    "a scaling figure" if shared else
                    "one rank per card, collectives over NCCL")),
            "ms_rank0": first["ms"]}


# ----------------------------------------------------------- phase 13 ----

# The multichip path: entry.dryrun_multichip's world of 4 rank processes on
# the one card (gloo, each on cuda:0; NCCL, one rank per card, under
# --parallel on 4 cards), then the sharded train step at the flagship's
# full width in a world of the same shape, then examples.impala_training in
# a world of one.
MC_WORLD = 4
MC_MESH = {"data": 2, "model": 2}
MC_B, MC_STEPS, MC_REPS = 256, 3, 5     # global B: 128 per rank (V2)
IMPALA_STEPS = 5
# The kernels each rank of a part must launch: the dryrun's train legs take
# V1 (8 rows per rank) and its time-sharded legs kernel 6; the full width
# (128 rows per rank) and impala_training (B=64) take V2; all take kernels
# 1, 2 and 3, the LSTM kernels in both dtypes.
MC_TRAIN_KERNELS = ("lstm_layer_fused", "lstm_layer_fused_bf16",
                    "vtrace_losses", "vtrace_returns_adv")
MC_PART_KERNELS = {
    "dryrun": MC_TRAIN_KERNELS + ("lstm_layer_bwd_v1",
                                  "lstm_layer_bwd_v1_bf16", "linear_scan"),
    "full_width": MC_TRAIN_KERNELS + ("lstm_layer_bwd_v2",
                                      "lstm_layer_bwd_v2_bf16"),
    "impala_training": MC_TRAIN_KERNELS + ("lstm_layer_bwd_v2",
                                           "lstm_layer_bwd_v2_bf16")}
MC_KERNELS = tuple(dict.fromkeys(k for ks in MC_PART_KERNELS.values()
                                 for k in ks))
# The sharded step against the unsharded step on the card, after each
# step: float32 as phase train holds the card against the CPU (RTOL/ATOL
# on the metrics, RTOL and GRAD_ATOL_REL of each leaf's max|want| on the
# gradients); bf16 at the bf16 train step's bounds (entry.TRAIN_TOLERANCE).
# The new parameters by entry.sharded_train_steps' rule.
MC_F32_TOLERANCE = {"metrics": {"rtol": RTOL, "atol": ATOL},
                    "grads": {"rtol": RTOL, "atol": 0.0,
                              "atol_rel": GRAD_ATOL_REL}}
MC_TAG = "MULTICHIP_RANK "
# A world that has not finished by then is killed and the phase fails.
MC_TIMEOUT_S = 300


def train_check_summary(checks: dict) -> dict:
    """The worst errors of one step of entry.sharded_train_steps' checks:
    metrics, gradients (over max|want|), the parameters against Adam's
    update by the gathered gradient and, at the first step, against the
    unsharded step where |grad| is big; the largest move."""
    leaves = [v for k, v in checks.items() if k != "metrics"]
    out = {"metrics_max_abs_err": max(c["max_abs_err"] for c in
                                      checks["metrics"].values()),
           "grad_max_err_over_max": max(v["grad"]["max_err_over_max"]
                                        for v in leaves),
           "param_vs_adam_max_abs_err": max(
               v["param_vs_adam"]["max_abs_err"] for v in leaves),
           "param_max_moved": max(v["param_moved"] for v in leaves)}
    if "param_big_grad" in leaves[0]:
        out["param_big_grad_max_abs_err"] = max(
            v["param_big_grad"]["max_abs_err"] for v in leaves)
    return out


def multichip_worker(workdir, rank: int, world: int) -> int:
    """One rank of phase multichip's full-width world: MC_STEPS sharded
    train steps in f32 and in bf16 (entry.sharded_train_steps: each step
    against the unsharded step from the same state), the sharded calls'
    launches and LSTM routes counted, then host-clock medians of MC_REPS
    sharded and unsharded steps.  Prints one line, MC_TAG and a JSON
    object."""
    import torch.distributed as dist

    from di_hpc_tpu_torch import entry, parallel as P

    start = time.perf_counter()
    P.initialize(f"file://{os.path.join(workdir, 'store')}", world, rank)
    mesh = P.make_mesh(MC_MESH)
    dev = mesh.device
    rng = np.random.default_rng(SEED + 40)
    arrays = model_arrays(rng)
    batches_np = [train_batch(rng, MC_B) for _ in range(MC_STEPS)]
    batches = [models.TrainBatch(*(torch.from_numpy(np.asarray(a)).to(dev)
                                   for a in b)) for b in batches_np]
    cfg = models.ActorCriticConfig(OBS, HID, LAYERS, ACTIONS)
    tally = entry.LaunchTally()
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev),
           "checks": {}, "ms": {}, "digests": {},
           "seconds": {"set_up": time.perf_counter() - start}}
    for tag, dtype, tol in (("f32", None, MC_F32_TOLERANCE),
                            ("bf16", torch.bfloat16,
                             entry.TRAIN_TOLERANCE[torch.bfloat16])):
        start = time.perf_counter()
        results, checks = entry.sharded_train_steps(
            cfg, arrays, batches, mesh, dtype, tally=tally, tolerance=tol,
            name=f"multichip {tag}")
        out["seconds"][f"checked_steps_{tag}"] = time.perf_counter() - start
        out["digests"][tag] = entry.digest(results)
        out["checks"][tag] = {step: train_check_summary(c)
                              for step, c in checks.items()}
        out["metrics_" + tag] = {k: float(results[f"step{MC_STEPS - 1}/"
                                                  f"metrics/{k}"])
                                 for k in ("total_loss", "policy_loss",
                                           "value_loss", "entropy")}
        shardings = models.actor_critic_shardings(mesh, LAYERS)
        params = models.ActorCriticParams(*P.shard_params(
            models.from_jax_params(arrays, device=dev).params(), shardings))
        step = models.make_sharded_train_step(
            cfg, torch.optim.Adam(params.parameters(), lr=1e-3), mesh,
            compute_dtype=dtype)
        local = P.shard_batch_pytree(mesh, batches[0],
                                     models.TrainBatch(1, 1, 1, 1))
        ref, ref_step, ref_batch = train_setup(arrays, batches_np[0], dev,
                                               dtype)
        out["ms"][tag] = {
            "sharded": host_ms(lambda: step(params, local), MC_REPS),
            "unsharded": host_ms(lambda: ref_step(ref, ref_batch),
                                 MC_REPS)}
    out["launches"] = tally.launches
    out["lstm_routes"] = tally.routes
    print(MC_TAG + json.dumps(out), flush=True)
    dist.destroy_process_group()
    return 0


def phase_multichip(dev) -> dict:
    from di_hpc_tpu_torch import entry
    from di_hpc_tpu_torch.examples import impala_training

    start = time.perf_counter()
    dryrun = entry.dryrun_multichip(MC_WORLD)
    dryrun_s = time.perf_counter() - start
    routes = [rep["lstm_routes"] for rep in dryrun]
    if any(r["recurrent"] for r in routes):
        raise AssertionError(f"dryrun: sharded LSTM layers took the "
                             f"recurrent path: {routes}")

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = spawn_world([os.path.abspath(__file__), "--multichip-worker",
                            tmp], MC_WORLD, MC_TIMEOUT_S)
    full_s = time.perf_counter() - start
    reports = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith(MC_TAG))[len(MC_TAG):])
               for out in outs]
    for rep in reports[1:]:
        if rep["digests"] != reports[0]["digests"]:
            raise AssertionError(f"full width: rank {rep['rank']}'s "
                                 f"results differ from rank 0's bits")
    for rep in reports:
        if rep["lstm_routes"]["recurrent"]:
            raise AssertionError(f"full width: rank {rep['rank']}'s LSTM "
                                 f"layers took the recurrent path: "
                                 f"{rep['lstm_routes']}")

    start = time.perf_counter()
    kernels.reset_launch_counts()
    network.reset_route_counts()
    impala = {}
    for tag, bf16 in (("f32", False), ("bf16", True)):
        params, metrics = impala_training.main(steps=IMPALA_STEPS, bf16=bf16)
        check_finite(f"impala_training {tag}", list(metrics.values())
                     + list(params.parameters()))
        impala[tag] = {k: float(v) for k, v in metrics.items()}
    torch.cuda.synchronize()
    impala_launches = kernels.launch_counts()
    impala_routes = dict(network.lstm_fused.routes)
    impala_s = time.perf_counter() - start
    if impala_routes["recurrent"]:
        raise AssertionError(f"impala_training: LSTM layers took the "
                             f"recurrent path: {impala_routes}")

    by_rank = {"dryrun": [rep["launches"] for rep in dryrun],
               "full_width": [rep["launches"] for rep in reports],
               "impala_training": [impala_launches]}
    for part, group in by_rank.items():
        for r, counts in enumerate(group):
            check_launched(f"multichip {part}, rank {r}",
                           {n: counts.get(n, 0) for n in MC_KERNELS},
                           MC_PART_KERNELS[part])
    launches = {name: sum(counts.get(name, 0) for group in by_rank.values()
                          for counts in group) for name in impala_launches}
    check_launched("multichip", launches, MC_KERNELS)
    first = reports[0]
    return {
        "world": MC_WORLD, "backend": first["backend"],
        "devices": [rep["device"] for rep in reports],
        "dryrun": {"line": dryrun[0]["line"], "seconds": dryrun_s,
                   "backend": dryrun[0]["backend"],
                   "mesh": dryrun[0]["mesh"], "sp_mesh": dryrun[0]["sp_mesh"],
                   "lstm_routes_by_rank": routes,
                   "checks_worst_rank": {
                       leg: max((rep["checks"][leg] for rep in dryrun),
                                key=lambda c: c["max_abs_err"])
                       for leg in entry.LEG_TOLERANCE},
                   "train_checks_rank0": {
                       leg: train_check_summary(dryrun[0]["checks"][leg])
                       for leg in ("train_step_sharded",
                                   "train_step_bf16_sharded")}},
        "full_width": {
            "mesh": MC_MESH, "shape": {"obs": OBS, "H": HID, "L": LAYERS,
                                       "A": ACTIONS, "T": T_TR, "B": MC_B,
                                       "B_per_rank": MC_B // MC_MESH["data"]},
            "steps": MC_STEPS, "seconds": full_s,
            "seconds_rank0": first["seconds"],
            "tolerance": {"f32": MC_F32_TOLERANCE,
                          "bf16": entry.TRAIN_TOLERANCE[torch.bfloat16],
                          "params": {"atol": entry.PARAM_ATOL,
                                     "grad_big": entry.GRAD_BIG}},
            "bitwise_equal_ranks": len(reports),
            "lstm_routes_by_rank": [rep["lstm_routes"] for rep in reports],
            "checks_worst_rank": {
                tag: {step: max((rep["checks"][tag][step] for rep in
                                 reports),
                                key=lambda c: c["grad_max_err_over_max"])
                      for step in first["checks"][tag]}
                for tag in first["checks"]},
            "metrics_last_step": {tag: first[f"metrics_{tag}"]
                                  for tag in ("f32", "bf16")},
            "ms_rank0": first["ms"],
            "timing_note": (
                f"host-clock medians of rank 0 over {MC_REPS} steps at "
                f"T={T_TR}, B={MC_B} (sharded: 128 rows per rank); " + (
                    "four processes share one card and stage every "
                    "collective through the host (gloo): not a scaling "
                    "figure" if first["backend"] == "gloo" else
                    "one rank per card, collectives over NCCL"))},
        "impala_training": {"steps": IMPALA_STEPS, "seconds": impala_s,
                            "last_metrics": impala,
                            "lstm_routes": impala_routes},
        "launches_by_rank": {part: [{n: c.get(n, 0) for n in MC_KERNELS}
                                    for c in group]
                             for part, group in by_rank.items()},
        "launches": launches}


# ----------------------------------------------------------- phase 14 ----

def profile_one(fn) -> dict:
    """torch.profiler over one call of fn after a warm-up call: device busy
    time (the sum of kernel and copy times on the one stream), the wall time
    of the window (profiler overhead included), the top kernels by device
    time and, under `port`, every kernel of the port that ran (they live in
    file-scope anonymous namespaces, so their names start with
    "(anonymous namespace)::", after "void " where they return nothing;
    PyTorch's few such kernels name their at:: functors)."""
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
    entry = lambda k, c, t: {"kernel": k[:120], "count": c, "ms": t / 1e3}
    ours = "(anonymous namespace)::"
    port = [entry(*r) for r in rows
            if r[0].removeprefix("void ").startswith(ours)
            and "at::" not in r[0]]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "top": [entry(*r) for r in rows[:10]], "port": port}


def phase_profile(dev) -> dict:
    """profile_one over each timed call of the slice, the train step at
    B=256 and at B=32 (V1) in float32 and in bf16, the three on-policy
    calls and the weighted ops.td_lambda_error (kernel 8's launch), the
    UPGO loss, the AlphaStar train step, the four scan entry points of
    phase upgo (kernel 6's launches), phase nstep's five TD ops and R2D2
    train step, phase replay's C51, QR-DQN and IQN steps, and phase
    hostdata's episodic A2C step and learner step.  In a checkout without
    the example modules of example_modules() it leaves out the PPO,
    AlphaStar, R2D2 and replay steps."""
    examples = have_examples()
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
    rng = np.random.default_rng(SEED + 9)
    params, step, batch = train_setup(model_arrays(rng), train_batch(rng, B),
                                      dev, torch.bfloat16)
    out[f"bf16_train_step_T{T_TR}_B{B}"] = profile_one(
        lambda: step(params, batch))
    # The B=32 legs, whose backward is V1, in f32 and in bf16.
    rng = np.random.default_rng(SEED + 10)
    arrays, B = model_arrays(rng), TRAIN_LEGS[1][0]
    batch_np = train_batch(rng, B)
    for tag, dtype in (("", None), ("bf16_", torch.bfloat16)):
        params, step, batch = train_setup(arrays, batch_np, dev, dtype)
        out[f"{tag}train_step_T{T_TR}_B{B}"] = profile_one(
            lambda: step(params, batch))
    rng = np.random.default_rng(SEED + 5)
    x = to_dev(onpolicy_arrays(rng), dev)
    for name, fn in onpolicy_timed_calls(
            x, ppo_params(rng, **PPO_CFG),
            ppo_rollouts(rng, 1, **PPO_CFG), dev, examples).items():
        out[name] = profile_one(fn)
    # The weighted call, whose returns plane is kernel 8's one launch.
    out["td_lambda_weighted_T1024_B4096"] = profile_one(
        lambda: ops.td_lambda_error(ops.td_lambda_data(
            x["value"], x["reward"], x["weight"]), 0.9, 0.8))
    rng = np.random.default_rng(SEED + 7)
    x = to_dev(upgo_arrays(rng), dev)
    as_np = alphastar_arrays(rng, **AS_CFG)
    timed = upgo_timed_calls(x, as_np, alphastar_batches(rng, 1, **AS_CFG),
                             dev, examples)
    for name in ("upgo_loss_fwd_bwd_T128_B512_N128",
                 "alphastar_train_step_T16_B8"):
        if name in timed:
            out[name] = profile_one(timed[name])
    out["scan_entry_points_T1024_B4096"] = profile_one(
        lambda: run_scan_entry_points(x))
    # Phase nstep's timed calls (the five TD ops, the R2D2 step), where the
    # checkout has the TD family (--profile also runs in an older one).
    if hasattr(ops, "qrdqn_nstep_td_error"):
        rng = np.random.default_rng(SEED + 23)
        x = {k: to_dev(v, dev) for k, v in nstep_arrays(rng).items()}
        for name, fn in nstep_timed_calls(
                x, r2d2_arrays(rng, **R2D2_CFG),
                r2d2_batches(rng, 1, **R2D2_CFG), dev, examples).items():
            out[name] = profile_one(fn)
    # Phase replay's three learners, one step each at its configuration.
    if examples:
        for name, (seed, lr, init, draw, step) in replay_learners(
                example_modules()).items():
            gen = torch.Generator().manual_seed(seed)
            p = init(gen, dev)
            target = copy.deepcopy(p)
            opt = torch.optim.Adam(p.parameters(), lr=lr)
            batch = draw(gen, dev)
            out[f"{name}_train_step"] = profile_one(
                lambda: step(p, target, opt, batch))
    # Phase hostdata's episodic A2C step and learner step, where the
    # checkout has the examples.
    if importlib.util.find_spec("di_hpc_tpu_torch.examples") is not None:
        for name, fn in hostdata_timed_calls(dev).items():
            out[name] = profile_one(fn)
    return out


KERNELS = (
    ("lstm_layer_fused", "di_hpc_tpu_torch/csrc/lstm_layer_cluster.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:115", "lstm_layer_fused S=33"),
    ("lstm_layer_bwd_v2", "di_hpc_tpu_torch/csrc/lstm_layer_bwd_v2.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:389", "lstm_layer_bwd_v2 S=33"),
    ("lstm_layer_bwd_v1", "di_hpc_tpu_torch/csrc/lstm_layer_bwd_v1.cu",
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
    ("categorical_fwd", "di_hpc_tpu_torch/csrc/categorical.cu",
     "none (XLA fusion): di_hpc_tpu/ops/categorical.py:37",
     "categorical_fwd T=1024"),
    ("categorical_bwd", "di_hpc_tpu_torch/csrc/categorical.cu",
     "none (XLA fusion): di_hpc_tpu/ops/categorical.py:37",
     "categorical_bwd T=1024"),
    ("lstm_layer_fused_bf16", "di_hpc_tpu_torch/csrc/lstm_layer_cluster.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:115",
     "lstm_layer_fused bf16 S=33"),
    ("lstm_layer_bwd_v2_bf16", "di_hpc_tpu_torch/csrc/lstm_layer_bwd_v2.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:389",
     "lstm_layer_bwd_v2 bf16 S=33"),
    ("lstm_layer_bwd_v1_bf16", "di_hpc_tpu_torch/csrc/lstm_layer_bwd_v1.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:276",
     "lstm_layer_bwd_v1 bf16 S=33"),
)


# Kernel 1's digest rows (S, B, H): both routes, 24- and 8-row groups.
FWD_DIGEST_ROWS = ((33, 256, 512), (1, 8, 512), (9, 64, 510))


def digests(dev) -> dict:
    """sha256 of the LSTM kernels' outputs -- kernel 1 (with and without
    the stash) at FWD_DIGEST_ROWS, V2 and V1 at BWD_ROWS' shapes; f32 and
    bf16 -- on inputs from the plain forward (so the backward's do not
    depend on kernel 1), ptxas' register and spill lines of their
    instantiations, and the scan kernels' digests (scan_digests).  Run in
    two checkouts, the digests show whether a change left these kernels
    bitwise the same."""
    sha = sha256
    lib = _build.library()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(SEED + 16)
        for S, B, H in FWD_DIGEST_ROWS:
            fwd = lstm_inputs(rng, S, B, H, dev, dtype)
            for name in ("lstm_layer_fused", "lstm_layer_stash"):
                out[f"{name} {dtype} S={S} B={B} H={H}"] = sha(
                    getattr(kernels, name)(*fwd))
        rng = np.random.default_rng(SEED + 15)
        for name, S, B, H in BWD_ROWS:
            fwd = lstm_inputs(rng, S, B, H, dev, dtype)
            y, c_seq, _, _ = kernels.lstm_layer_stash_plain(*fwd)
            gxp, wh, glnx, blnx, gln, bln, bias, h0, c0 = fwd
            dy, dhn, dcn = (torch.from_numpy(rng.standard_normal(
                shape, dtype=np.float32)).to(dev, dtype)
                for shape in ((S, B, H), (B, H), (B, H)))
            args = (gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0,
                    c0, dhn, dcn)
            if name.endswith("v1"):
                args = (*kernels.lstm_layer_bwd_v1_streams(
                    gxp, y, c_seq, wh, glnx, blnx, bias, h0, c0), c_seq, dy,
                    wh, gln, bln, dhn, dcn)
            out[f"{name} {dtype} S={S} B={B} H={H}"] = sha(
                getattr(kernels, name)(*args))
    for kernel in ("lstm_layer_cluster_kernel", "lstm_layer_fwd_kernel",
                   "lstm_layer_bwd_v2_kernel", "lstm_layer_bwd_v1_kernel"):
        for tag in ("If", "I13__nv_bfloat16"):
            out[f"ptxas {kernel}{tag}"] = ptxas_of(lib.build_log, kernel, tag)
    out.update(scan_digests(dev, sha))
    return out


# The scan kernels' digest shapes: the north-star plane and a ragged one
# (a partial super-tile and a partial column tile).
SCAN_DIGEST_SHAPES = ((1024, 4096), (1000, 4100))


def scan_digests(dev, sha) -> dict:
    """sha256 of the outputs of the scan kernels (2, 3, 6-12) at
    SCAN_DIGEST_SHAPES, through their wrappers, on inputs from one seed.
    Only the wrappers' public arguments are used, so an older checkout with
    this script copied in gives its own kernels' digests."""
    out = {}
    rng = np.random.default_rng(SEED + 20)
    for T, B in SCAN_DIGEST_SHAPES:
        f = lambda *s: torch.from_numpy(rng.standard_normal(
            s, dtype=np.float32)).to(dev)
        is_w, lp, reward, value = (torch.exp(0.3 * f(T, B)),
                                   -f(T, B).abs(), f(T, B), f(T + 1, B))
        a, y = f(T, B), f(B)
        b = torch.from_numpy(rng.uniform(0.5, 1.0, (T, B)).astype(
            np.float32)).to(dev)
        runs = {
            "vtrace_losses": lambda: kernels.vtrace_losses(
                is_w, lp, reward, value, *VTRACE_CLIPS),
            "vtrace_returns_adv": lambda: kernels.vtrace_returns_adv(
                is_w, reward, value, *VTRACE_CLIPS),
            "linear_scan reverse": lambda: [kernels.linear_scan(
                a, b, y, True)],
            "linear_scan forward": lambda: [kernels.linear_scan(
                a, b, y, False)],
            **{name: (lambda name=name: [getattr(kernels, name)(
                value, reward, *SCAN_ARGS[name])]) for name in SCAN_ARGS},
            "upgo_advantages": lambda: [kernels.upgo_advantages(
                is_w, reward, value)],
            "upgo_loss": lambda: [kernels.upgo_loss(is_w, lp, reward,
                                                    value)]}
        for name, run in runs.items():
            out[f"{name} T={T} B={B}"] = sha([t.reshape(-1) for t in run()])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on a card and has no CPU mode", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in float32, as the TPU's do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--digests"]:
        with torch.inference_mode():
            emit({"digests": digests(dev)})
        return 0
    if sys.argv[1:] == ["--profile"]:
        emit({"profile": phase_profile(dev)})
        return 0
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]))
    if sys.argv[1:2] == ["--multichip-worker"]:
        return multichip_worker(sys.argv[2], int(sys.argv[3]),
                                int(sys.argv[4]))
    if sys.argv[1:] == ["--parallel"]:
        for name, fn in (("device", phase_device), ("build", phase_build),
                         ("parallel", lambda: phase_parallel(dev)),
                         ("multichip", lambda: phase_multichip(dev))):
            start = time.perf_counter()
            emit({"phase": name, "ok": True, **fn(),
                  "seconds": time.perf_counter() - start})
        return 0

    results = {}
    for name, fn in (("device", phase_device), ("build", phase_build),
                     ("kernels", lambda: phase_kernels(dev)),
                     ("slice", lambda: phase_slice(dev)),
                     ("train", lambda: phase_train(dev)),
                     ("bf16", lambda: phase_bf16(dev)),
                     ("onpolicy", lambda: phase_onpolicy(dev)),
                     ("upgo", lambda: phase_upgo(dev)),
                     ("nstep", lambda: phase_nstep(dev)),
                     ("replay", lambda: phase_replay(dev)),
                     ("hostdata", lambda: phase_hostdata(
                         dev, results["kernels"])),
                     ("parallel", lambda: phase_parallel(dev)),
                     ("multichip", lambda: phase_multichip(dev)),
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
    # Launches on each counted path run: the slice, the train legs, the bf16
    # path, the on-policy path, the UPGO/AlphaStar path, the TD family and
    # the R2D2 learner, the replay learners (none), the five examples'
    # main() runs, the host data plane with its two examples, the parallel
    # layer's world (summed over its ranks), the multichip path (its two
    # worlds summed over their ranks, and impala_training).
    by_path = {"slice": results["slice"]["launches"],
               **{f"train {leg}": results["train"][leg]["launches"]
                  for leg in results["train"] if leg.startswith("B=")},
               "bf16": results["bf16"]["launches"],
               "onpolicy": results["onpolicy"]["launches"],
               "upgo": results["upgo"]["launches"],
               "nstep": results["nstep"]["launches"],
               "replay": results["replay"]["launches"],
               "examples": results["replay"]["examples"]["launches"],
               "hostdata": results["hostdata"]["launches"],
               "parallel": results["parallel"]["launches"],
               "multichip": results["multichip"]["launches"]}
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
