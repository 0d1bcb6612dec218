"""The yardstick's arithmetic, by hand at the cells' configurations and at
the JAX package's framework config and north-star shape, and each
per-layer reader on a made-up trace."""

import torch
import pytest

from benchmark.core import peaks, spec as specs
from benchmark.core.session import Context
from benchmark.core.trace import Trace, breakdown, short_name, with_busy

SPEC = specs.benchmark_spec()
H100 = peaks.peak("NVIDIA H100 80GB HBM3")
LEARNER = specs.load_config("dihpc_lstm_h384", SPEC)
VTRACE = specs.load_config("vtrace_t1024_b4096_n128", SPEC)
LCELL, VCELL = "dihpc_lstm_h384.f32_b128", "vtrace_t1024_b4096_n128.fwd_bwd"
# The JAX package's bench config (obs 256, H 512, 2 layers, 64 actions,
# T 32, B 256) and north-star V-trace shape (N 32): the sizes the port's
# bring-up measured, kept as hand-checked cases of the same arithmetic.
FRAMEWORK = {"obs_dim": 256, "hidden_size": 512, "num_layers": 2,
             "action_dim": 64}
NORTH_STAR = {"unroll": 1024, "batch": 4096, "action_dim": 32}
K1 = "void (anonymous namespace)::lstm_layer_cluster_kernel<float, true>(float const*, int)"
K4 = "void (anonymous namespace)::lstm_layer_bwd_v2_kernel<float>(float const*)"
K2 = "void (anonymous namespace)::vtrace_chunked_kernel<true>(float const*)"
K3 = "void (anonymous namespace)::vtrace_chunked_kernel<false>(float const*)"
GEMM = "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32"


def metric(name):
    return specs.load_module("metrics", name)


def ctx(cell, window=None):
    c = specs.load_cell(cell, SPEC)
    return Context(1, 1.0, True, c, specs.load_config(c["config"], SPEC),
                   torch.device("cpu"), H100,
                   extra={"window": window or {"window_s": 1.0, "steps": 1}})


@pytest.mark.parametrize("cfg, T, B, forward, backward", [
    # forward 2*65*128*(1792*384 + 3*8*384^2 + 384*128 + 384) = 71.163 G;
    # backward twice that less the embedding's input gradient,
    # 2*65*128*1792*384 = 11.450 G: 202.0 G a step.
    (LEARNER, 64, 128, 71_162_757_120, 130_875_064_320),
    # forward 2*33*256*(256*512 + 2*8*512^2 + 512*64 + 512) = 73.644 G;
    # less 2*33*256*256*512 = 2.215 G: 218.7 G a step.
    (FRAMEWORK, 32, 256, 73_643_851_776, 145_073_111_040)])
def test_model_flops_by_hand(cfg, T, B, forward, backward):
    flops = metric("mfu").model_flops(cfg, T, B)
    assert flops == forward + backward
    assert forward == 2 * (T + 1) * B * (
        cfg["obs_dim"] * cfg["hidden_size"]
        + cfg["num_layers"] * 8 * cfg["hidden_size"] ** 2
        + cfg["hidden_size"] * cfg["action_dim"] + cfg["hidden_size"])


def test_learner_config_flops_per_step():
    assert round(metric("mfu").model_flops(LEARNER, 64, 128) / 1e9, 1) \
        == 202.0
    assert round(metric("mfu").model_flops(FRAMEWORK, 32, 256) / 1e9, 1) \
        == 218.7


@pytest.mark.parametrize("cfg, nbytes, ms", [
    (VTRACE, 6_509_592_576, 1.9432), (NORTH_STAR, 1_677_754_368, 0.5008)])
def test_vtrace_call_bytes_by_hand(cfg, nbytes, ms):
    T, B, N = cfg["unroll"], cfg["batch"], cfg["action_dim"]
    got = metric("hbm_mfu").call_bytes(cfg)
    assert got == 3 * 4 * T * B * N + 4 * (2 * (T + 1) * B + 2 * T * B)
    assert got == nbytes
    assert got / H100["hbm_bytes_per_s"] * 1e3 == pytest.approx(ms,
                                                                abs=1e-4)


def test_lstm_counts_at_the_framework_config():
    m = metric("lstm_roofline")
    nbytes, flops = m.forward_counts(33, 256, 512, 4)
    assert flops == 2 * 33 * 256 * 512 * 2048 == 17_716_740_096
    # gx, Wh, 5 vectors, h0 and c0 in; y, c stash, h_n, c_n out.
    assert nbytes == 4 * (33 * 256 * 2048 + 512 * 2048 + 5 * 2048
                          + 4 * 256 * 512 + 2 * 33 * 256 * 512)
    b4, f4 = m.backward_counts("v2", 33, 256, 512, 4)
    assert f4 == 2 * flops
    assert b4 == pytest.approx(266.1e6, rel=2e-3)
    # Bounds: kernel 1 by its operations at TF32, kernel 4 by its bytes.
    assert peaks.bound_s(nbytes, flops, H100, "float32") * 1e3 == \
        pytest.approx(0.0358, abs=1e-4)
    assert peaks.bound_s(b4, f4, H100, "float32") * 1e3 == \
        pytest.approx(0.0794, abs=1e-4)


def test_vtrace_kernel_counts():
    m = metric("scan_roofline")
    assert m.losses_counts(1024, 4096)[0] / 3.35e12 * 1e3 == \
        pytest.approx(0.0200, abs=1e-4)
    assert m.returns_counts(1024, 4096)[0] / 3.35e12 * 1e3 == \
        pytest.approx(0.0250, abs=1e-4)


def made_up_trace(kernels, steps=2, window=(0, 10_000_000), host=(),
                  launch_at=None):
    return with_busy(Trace(list(kernels), list(host), dict(launch_at or {}),
                           steps, window))


def test_readers_on_a_made_up_learner_trace():
    # Two steps of 5 ms; per step two kernel-1 launches of 1 ms, two
    # kernel-4 launches of 1.5 ms and an Adam kernel of 0.2 ms.
    ks, host, launch = [], [], {}
    corr = 0
    for step in range(2):
        t0 = step * 5_000_000
        for name, at, dur in [(K1, 0, 1_000_000), (K1, 1_000_000, 1_000_000),
                              (K4, 2_000_000, 1_500_000),
                              (K4, 3_500_000, 1_000_000),
                              (GEMM, 4_500_000, 200_000)]:
            corr += 1
            s = t0 + at
            ks.append((name, s, s + dur, corr))
            launch[corr] = s - 10
        host.append(("Optimizer.step#Adam.step", t0 + 4_400_000,
                     t0 + 4_800_000))
    trace = made_up_trace(ks, host=host, launch_at=launch)
    c = ctx(LCELL, {"window_s": 0.04, "steps": 10})
    busy = trace.busy_s
    assert busy == pytest.approx(2 * 4.7e-3)
    assert metric("device_idle_share").read(trace, c) == pytest.approx(6.0)
    assert metric("adam_ms").read(trace, c) == pytest.approx(0.2)
    flops = metric("mfu").model_flops(LEARNER, 64, 128)
    assert metric("mfu").read(trace, c) == pytest.approx(
        100 * flops / 4e-3 / 495e12)
    m = metric("lstm_roofline")
    b1 = peaks.bound_s(*m.forward_counts(65, 128, 384, 4), H100, "float32")
    b4 = peaks.bound_s(*m.backward_counts("v2", 65, 128, 384, 4), H100,
                       "float32")
    assert m.read(trace, c) == pytest.approx(
        100 * (4 * b1 + 4 * b4) / (4e-3 + 5e-3))
    b = breakdown(trace)
    assert b["device_ops"][0][0] == short_name(K4)
    assert len(b["idle_gaps"]) >= 1


def test_readers_on_a_made_up_vtrace_trace():
    ks = [(K2, 0, 50_000, 1), ("at::native::reduce_kernel", 50_000,
                                 10_000_000, 2), (K3, 10_000_000,
                                                  10_040_000, 3)]
    trace = made_up_trace(ks, steps=1, window=(0, 12_000_000))
    c = ctx(VCELL, {"window_s": 0.12, "steps": 10})
    assert metric("vtrace_head_ms").read(trace, c) == pytest.approx(9.95)
    m = metric("scan_roofline")
    want = (m.losses_counts(1024, 4096)[0] + m.returns_counts(1024, 4096)[0]
            ) / 3.35e12 / 90e-6
    assert m.read(trace, c) == pytest.approx(100 * want)
    assert metric("hbm_mfu").read(trace, c) == pytest.approx(
        100 * 6_509_592_576 / 3.35e12 / 12e-3)


def test_readers_find_nothing_where_nothing_ran():
    trace = made_up_trace([(GEMM, 0, 1000, 1)])
    c = ctx(LCELL)
    assert metric("lstm_roofline").read(trace, c) is None
    assert metric("adam_ms").read(trace, c) is None
    assert metric("scan_roofline").read(
        trace, ctx(VCELL)) is None
    assert metric("vtrace_head_ms").read(
        trace, ctx(VCELL)) is None


def test_short_names():
    assert short_name(K1) == ("(anonymous namespace)::"
                              "lstm_layer_cluster_kernel<float, true>")
    assert short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


def test_busy_is_the_union_of_device_intervals():
    trace = made_up_trace([(GEMM, 100, 400, 1), (K1, 300, 600, 2),
                           (K4, 800, 900, 3)], window=(0, 1000))
    assert trace.busy_ns == 600
    assert trace.gaps == [(0, 100), (600, 800), (900, 1000)]
