"""The readers of the program's spans (`core/spans.py`, `lstm_fwd_ms`,
`spans.py`'s all-thread numbers) on made-up profiles, a backward launched
from a second thread among them; None where the spans are missing;
`reduce_profile`'s fields, the breakdown's device operations and the eight
readers that came before the spans, pinned on a fixed event list and
unchanged by the spans; and, on the card, the learner cell's span report
against its kernels by name, every LSTM layer on the kernels' route."""

import json
import types

import pytest
import torch

from benchmark import spans as report_tool
from benchmark.core import peaks, spans as sp, spec as specs
from benchmark.core.session import Context
from benchmark.core.trace import breakdown, reduce_profile

SPEC = specs.benchmark_spec()
LCELL, VCELL = "dihpc_lstm_h384.f32_b128", "vtrace_t1024_b4096_n128.fwd_bwd"
OLD = ("device_idle_share.train", "device_idle_share.loss", "mfu",
       "lstm_roofline", "adam_ms", "vtrace_head_ms", "hbm_mfu",
       "scan_roofline")
K1 = "void (anonymous namespace)::lstm_layer_cluster_kernel<float, 24, true>(float const*)"
K4 = "void (anonymous namespace)::lstm_layer_bwd_v2_kernel<float, 24>(float const*)"
GEMM = "cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>(Params)"
ADAM = "void at::native::multi_tensor_apply_kernel<Adam>(Params)"
MAIN, ENGINE = 1, 2                # the stepping thread, the engine's


class Ev:
    """A kineto event as reduce_profile reads it."""

    def __init__(self, name, s, e, thread=MAIN, corr=0, card=False,
                 annotation=False):
        self._v = (name, s, e, thread, corr, card, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[5] else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._v[6]


def profile_of(events):
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def ctx(cell, window=None):
    c = Context(1, 1.0, True, specs.load_cell(cell, SPEC),
                specs.load_config(specs.load_cell(cell, SPEC)["config"], SPEC),
                torch.device("cpu"), peaks.peak("NVIDIA H100 80GB HBM3"))
    c.extra["window"] = window or {"window_s": 0.02, "steps": 2}
    return c


def learner_events(spans: bool, fast: bool = True) -> list:
    """Two steps of 10 us each: a forward kernel-1 launch and a GEMM on the
    stepping thread, a kernel-4 launch on the engine's thread inside the
    backward, Adam; with `spans`, the program's ranges around them, as
    torch's fast ranges (plain host ranges) or, with `fast` false, as
    `record_function` ranges (user annotations, mirrored on the card)."""
    ev, corr = [], 0

    def launch(at, name, start, end, thread=MAIN):
        nonlocal corr
        corr += 1
        ev.append(Ev("cudaLaunchKernel", at, at + 50, thread, corr))
        ev.append(Ev(name, start, end, corr=corr, card=True))

    for step in range(2):
        t = step * 10_000
        ev.append(Ev("bm.step", t, t + 10_000, annotation=True))
        ev.append(Ev("bm.step", t + 900, t + 9_000, card=True,
                     annotation=True))             # its mirror on the card
        launch(t + 100, GEMM, t + 1_000, t + 2_000)
        launch(t + 300, K1, t + 2_000, t + 4_000)
        launch(t + 4_600, K4, t + 5_000, t + 8_000, ENGINE)
        ev.append(Ev("Optimizer.step#Adam.step", t + 8_100, t + 8_600,
                     annotation=True))
        launch(t + 8_200, ADAM, t + 8_600, t + 9_000)
        if spans:
            for name, s, e, th in (
                    ("dihpc.train.forward", 50, 4_500, MAIN),
                    ("dihpc.gemm.embed", 60, 200, MAIN),
                    ("dihpc.lstm.layer.kernel", 250, 400, MAIN),
                    ("dihpc.kernel.lstm_layer_fused", 280, 380, MAIN),
                    ("dihpc.train.backward", 4_500, 8_000, MAIN),
                    ("dihpc.lstm.layer.kernel.bwd", 4_550, 4_900, ENGINE),
                    ("dihpc.kernel.lstm_layer_bwd_v2", 4_580, 4_700, ENGINE),
                    ("dihpc.train.optimizer", 8_050, 8_700, MAIN)):
                ev.append(Ev(name, t + s, t + e, th, annotation=not fast))
                if not fast:
                    ev.append(Ev(name, t + s + 900, t + e + 900, card=True,
                                 annotation=True))
    return ev


def metric(name):
    return specs.load_module("metrics", name)


def old_readings(trace):
    return {name: metric(name).read(trace, ctx(
        VCELL if name.endswith(".loss") or name in (
            "vtrace_head_ms", "hbm_mfu", "scan_roofline") else LCELL))
        for name in OLD}


def test_reduce_profile_and_the_old_readers_are_pinned():
    trace = reduce_profile(profile_of(learner_events(spans=False)))
    assert trace.steps == 2 and trace.window == (0, 20_000)
    assert [k[0] for k in trace.kernels] == [GEMM, K1, K4, ADAM] * 2
    assert trace.busy_ns == 2 * (3_000 + 3_000 + 400)
    assert trace.gaps == [(0, 1_000), (4_000, 5_000), (8_000, 8_600),
                          (9_000, 11_000), (14_000, 15_000),
                          (18_000, 18_600), (19_000, 20_000)]
    # The engine thread's launches are not the stepping thread's.
    assert sorted(trace.launch_at) == [1, 2, 4, 5, 6, 8]
    assert old_readings(trace) == {
        "device_idle_share.train": pytest.approx(36.0),
        "device_idle_share.loss": pytest.approx(36.0),
        "mfu": pytest.approx(4.08157215030303),
        "lstm_roofline": pytest.approx(1640.2462567164177),
        "adam_ms": pytest.approx(0.0004), "vtrace_head_ms": None,
        "hbm_mfu": pytest.approx(19.431619629850747), "scan_roofline": None}


@pytest.mark.parametrize("fast", [True, False])
def test_the_spans_change_no_old_field_or_reader(fast):
    plain = reduce_profile(profile_of(learner_events(spans=False)))
    spanned = reduce_profile(profile_of(learner_events(True, fast)))
    for field in ("kernels", "launch_at", "steps", "window", "busy_ns",
                  "gaps"):
        assert getattr(spanned, field) == getattr(plain, field), field
    assert [h for h in spanned.host if not h[0].startswith("dihpc.")] == \
        plain.host
    assert old_readings(spanned) == old_readings(plain)
    assert breakdown(spanned)["device_ops"] == breakdown(plain)["device_ops"]
    idle = dict(breakdown(spanned)["idle_gaps"])
    assert idle["host: dihpc.train.backward"] == pytest.approx(2e-6)


def test_span_readers_on_the_stepping_thread():
    trace = reduce_profile(profile_of(learner_events(spans=True)))
    assert metric("lstm_fwd_ms").read(trace, ctx(LCELL)) == \
        pytest.approx(0.002)
    # The gaps whose middles lie in the forward (the first kernel's wait,
    # first step only), the backward (its start, each step) and the
    # optimizer's range; not the one between the steps nor the last.
    assert dict(sp.idle_by_span(trace, sp.host_spans(trace))) == {
        "host: no event open": pytest.approx(3e-6),
        "host: dihpc.train.backward": pytest.approx(2e-6),
        "host: dihpc.train.optimizer": pytest.approx(1.2e-6),
        "host: dihpc.train.forward": pytest.approx(1e-6)}


def test_backward_launches_from_another_thread():
    events = learner_events(spans=True)
    trace = reduce_profile(profile_of(events))
    spans, launch_at = sp.all_threads(profile_of(events), trace.window)
    assert {s[3] for s in spans if s[0].endswith(".bwd")} == {ENGINE}
    assert len(launch_at) == 8 and len(trace.launch_at) == 6
    names = ("dihpc.kernel.lstm_layer_bwd_v2",)
    assert sp.device_ms(trace, names, spans, launch_at) == \
        pytest.approx(0.003)
    # The stepping thread alone holds no backward span.
    assert sp.device_ms(trace, names) is None
    assert sp.device_ms(trace, ("dihpc.lstm.layer.kernel.bwd",), spans,
                        launch_at) == pytest.approx(0.003)
    idle = dict(sp.idle_by_span(trace, spans))
    assert idle["host: dihpc.train.backward"] == pytest.approx(2e-6)
    out = report_tool.report(trace, spans, launch_at, ctx(LCELL), SPEC)
    assert out["lstm_bwd_ms"] == pytest.approx(0.003)
    assert out["gemm_fwd_ms"] == pytest.approx(0.001)
    assert out["categorical_head_ms"] is None
    assert out["by_name"]["lstm_bwd"] == pytest.approx(0.003)
    assert out["span_counts"]["dihpc.kernel.lstm_layer_fused"] == 2


def test_span_readers_give_none_without_spans():
    trace = reduce_profile(profile_of(learner_events(spans=False)))
    assert metric("lstm_fwd_ms").read(trace, ctx(LCELL)) is None
    assert sp.device_ms(trace, ("dihpc.gemm.embed",)) is None
    assert sp.idle_by_span(trace, sp.host_spans(trace)) == [
        ["host: no event open", pytest.approx(7.2e-6)]]


def test_a_launch_outside_the_spans_is_not_counted():
    events = learner_events(spans=True)
    trace = reduce_profile(profile_of(events))
    spans, launch_at = sp.all_threads(profile_of(events), trace.window)
    # The embedding's span ends before kernel 1's launch; Adam's launch
    # lies in no `dihpc.kernel.` span, only in the optimizer's phase.
    assert sp.device_ms(trace, ("dihpc.gemm.embed",)) == \
        pytest.approx(0.001)
    assert sp.device_ms(trace, ("dihpc.train.optimizer",)) == \
        pytest.approx(0.0004)
    assert sp.device_ms(trace, ("dihpc.train.forward",), spans,
                        launch_at) == pytest.approx(0.003)


def test_report_of_a_tiny_learner_run_on_the_cpu(capsys):
    tiny = {"obs_dim": 8, "hidden_size": 16, "action_dim": 4, "unroll": 4,
            "batch": 6, "pool": 4}
    rc = report_tool.main(["--workload", LCELL, "--seed", str(2 ** 31 + 5),
                           "--seconds", "0.2"], device=torch.device("cpu"),
                          overrides=tiny)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    counts = line["span_counts"]
    steps = counts["dihpc.train.forward"]
    assert steps == line["steps"] >= 1
    L = specs.load_config("dihpc_lstm_h384", SPEC)["num_layers"]
    assert counts["dihpc.lstm.layer.kernel"] == L * steps
    assert counts["dihpc.lstm.layer.kernel.bwd"] == L * steps
    assert counts["dihpc.categorical.logp_entropy.bwd"] == steps
    assert not [n for n in counts if n.startswith("dihpc.gemm.")
                and n.endswith(".bwd")]


@pytest.mark.gpu
def test_learner_report_on_the_card(card, capsys):
    """The learner cell's spans on the card: every LSTM layer takes the
    kernels' route, and the kernels launched inside the launch spans are
    kernels 1 and 4 by name, to the nanosecond."""
    rc = report_tool.main(["--workload", LCELL, "--seed", str(2 ** 31 + 7),
                           "--seconds", "1"])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    counts, steps = line["span_counts"], line["steps"]
    L = specs.load_config("dihpc_lstm_h384", SPEC)["num_layers"]
    assert counts["dihpc.lstm.layer.kernel"] == L * steps
    assert "dihpc.lstm.layer.recurrent" not in counts
    assert line["metrics"]["lstm_fwd_ms"] == \
        pytest.approx(line["by_name"]["lstm_fwd"], rel=1e-9)
    assert line["lstm_bwd_ms"] == \
        pytest.approx(line["by_name"]["lstm_bwd"], rel=1e-9)
