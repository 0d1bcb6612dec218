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
  3. kernels -- calls each kernel on the card at the main path's shapes and
                holds it against its plain PyTorch version on the same
                inputs (float32 without TF32 on both sides); times both with
                CUDA events (median over repetitions).
  4. slice   -- the main path at full width, through the entry points a
                user calls, with every launch count set to 0 just before it
                and read just after: the LN-LSTM actor-critic (obs 256,
                hidden 512, 2 layers, 64 actions; random weights from a
                numpy seed) runs `actor_critic_forward` over a (33, 256)
                unroll, `ops.vtrace_error` on its logits and values (unit
                weight and weighted), 64 `actor_step` serving calls at B=256
                with the state carried, and `ops.vtrace_error` at T=1024,
                B=4096, N=32 (unit weight and weighted).  Outputs must be
                finite, of the expected shapes, every kernel must have been
                launched, and each output must agree with the same call's
                plain PyTorch run on the CPU.  Then ms per forward, per
                serving step and per V-trace call (host clock around
                synchronized work).
  5. profile -- torch.profiler over one more run of each of those three
                calls: device busy time, idle share of the window and the
                top kernels by device time.

Then one `{"kernels": [...]}` line, the nvidia-smi line, and, last, the
contract line `{"ok": true, "device": {...}}`.  Any failure prints its phase
with `"ok": false` and exits 1; no card (or no port beside this script)
exits non-zero before any result.
"""

from __future__ import annotations

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
from di_hpc_tpu_torch import kernels, models, ops, origin  # noqa: E402
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
    call, in ms."""
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


def compare(name, got, want, rtol=RTOL, atol=ATOL) -> dict:
    """Max abs/rel error of got against want; raises past the tolerance."""
    abs_err, rel_err, bad = 0.0, 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{name}[{i}]: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)} or non-finite values")
        d = (g - w).abs()
        abs_err = max(abs_err, float(d.max()))
        rel_err = max(rel_err, float((d / w.abs().clamp_min(1e-30)).max()))
        if not bool((d <= atol + rtol * w.abs()).all()):
            bad.append(i)
    result = {"max_abs_err": abs_err, "max_rel_err": rel_err}
    if bad:
        raise AssertionError(f"{name}: outputs {bad} outside rtol={rtol}, "
                             f"atol={atol}: {result}")
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
            row["ms"] = cuda_ms(lambda: kernels.lstm_layer_fused(*args), 7,
                                per_rep=3)
            row["plain_ms"] = cuda_ms(lambda: kernels.lstm_layer_plain(*args),
                                      5)
            row["bound_ms"], row["bound_by"] = bound_ms(*lstm_bound(S, B, H))
            rows[f"lstm_layer_fused S={S}"] = row

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
            row["ms"] = cuda_ms(lambda: kernels.vtrace_losses(
                is_w, lp, reward, value, *clips), 7, per_rep=10)
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
            row["ms"] = cuda_ms(lambda: kernels.vtrace_returns_adv(
                is_w, reward, value, *clips), 7, per_rep=10)
            row["plain_ms"] = cuda_ms(lambda: kernels.vtrace_returns_adv_plain(
                is_w, reward, value, *clips), plain_reps, warmup=1)
            row["bound_ms"], row["bound_by"] = bound_ms(rb, ro)
            rows[f"vtrace_returns_adv T={T}"] = row
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
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path was never launched: "
                             f"{launches}")

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
    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - start) * 1e3)
        return statistics.median(times)

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


def phase_profile(dev) -> dict:
    """torch.profiler over one run of each timed call: device busy time
    (the sum of kernel and copy times on the one stream), the wall time of
    the window (profiler overhead included) and the top kernels by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, params, obs, serve_obs, _, _, _, big_x = slice_inputs(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    with torch.inference_mode():
        for name, fn in timed_calls(params, obs, serve_obs, big_x, gen,
                                    dev).items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - start) * 1e3
            rows = [(e.key, e.count,
                     getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            rows.sort(key=lambda r: -r[2])
            busy_ms = sum(r[2] for r in rows) / 1e3
            out[name] = {
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
                "top": [{"kernel": k[:80], "count": c, "ms": t / 1e3}
                        for k, c, t in rows[:8]]}
    return out


KERNELS = (
    ("lstm_layer_fused", "di_hpc_tpu_torch/csrc/lstm_layer.cu",
     "di_hpc_tpu/pallas_kernels/lstm_cell.py:115", "lstm_layer_fused S=33"),
    ("vtrace_losses", "di_hpc_tpu_torch/csrc/vtrace.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:558", "vtrace_losses T=1024"),
    ("vtrace_returns_adv", "di_hpc_tpu_torch/csrc/vtrace.cu",
     "di_hpc_tpu/pallas_kernels/rl_scans.py:472", "vtrace_returns_adv T=1024"),
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
    launches = results["slice"]["launches"]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name],
         "max_abs_err": rows[key]["max_abs_err"], "ms": rows[key]["ms"],
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
