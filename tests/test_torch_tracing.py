"""The port's spans (utils.profiling.span) on the CPU, at tiny sizes: under
torch.profiler, `make_train_step`, `network.lstm_fused` and
`ops.vtrace_error` emit the `dihpc.` ranges nested as the layers are; the
results are bitwise the same with the profiler on and off; with no
profiler running a span is one shared null context, and the autograd graph
is the same with the profiler on and off; and each counted launch of a
kernel wrapper is one `dihpc.kernel.<name>` range (the launch itself faked,
since the kernels run only on a card)."""

import contextlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from di_hpc_tpu_torch import kernels, models, network, ops
from di_hpc_tpu_torch.kernels import lstm_cell, rl_scans
from di_hpc_tpu_torch.utils import profiling

CFG = models.ActorCriticConfig(obs_dim=12, hidden_size=16, num_layers=3,
                               action_dim=5)
T = 4


def _spans(prof) -> list:
    """(name, start, end, thread) of every `dihpc.` range on the host."""
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("dihpc.")
                   and not str(e.device_type()).endswith("CUDA")),
                  key=lambda s: s[1])


def _named(spans, name) -> list:
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _setup(B, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = models.init_actor_critic(CFG, gen, device="cpu")
    batch = models.TrainBatch(
        torch.randn(T + 1, B, CFG.obs_dim, generator=gen),
        torch.randint(0, CFG.action_dim, (T, B), generator=gen),
        torch.randn(T, B, generator=gen),
        torch.randn(T, B, CFG.action_dim, generator=gen))
    opt = torch.optim.Adam(params.parameters(), lr=1e-3)
    return params, models.make_train_step(CFG, opt), batch


def _graph_nodes(t: torch.Tensor) -> set:
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(f).__name__ for f in seen}


def test_span_without_a_profiler_is_the_shared_null_context():
    assert profiling.span("dihpc.a") is profiling.span("dihpc.b")
    assert isinstance(profiling.span("dihpc.a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = profiling.span("dihpc.a")
        assert on is not profiling.span("dihpc.b")
        with on:
            pass
    assert not isinstance(on, contextlib.nullcontext)
    assert [s[0] for s in _spans(prof)] == ["dihpc.a"]
    assert profiling.span("dihpc.a") is profiling.span("dihpc.b")


def test_spans_add_no_autograd_node():
    params, _, batch = _setup(3)

    def loss():
        logits, value, _ = models.actor_critic_forward(params, batch.obs)
        return logits.sum() + value.sum()

    off = _graph_nodes(loss())
    with profile(activities=[ProfilerActivity.CPU]):
        on = _graph_nodes(loss())
    assert on == off
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        out = models.actor_critic_forward(params, batch.obs)
    assert out[0].grad_fn is None
    assert [s[0] for s in _spans(prof)][:2] == ["dihpc.gemm.embed",
                                                "dihpc.gemm.lstm_input"]


@pytest.mark.parametrize("B", [3, 64])     # V1 and V2 backward routes
def test_train_step_spans_nest_as_the_layers(B):
    params, step, batch = _setup(B)
    network.reset_route_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, batch)
    spans = _spans(prof)
    phases = [_named(spans, "dihpc.train." + p)
              for p in ("zero_grad", "forward", "backward", "optimizer")]
    assert [len(p) for p in phases] == [1, 1, 1, 1]
    phases = [p[0] for p in phases]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    forward, backward = phases[1], phases[2]
    L = CFG.num_layers
    want = {"dihpc.lstm.layer.kernel": L, "dihpc.gemm.lstm_input": L,
            "dihpc.gemm.embed": 1, "dihpc.gemm.heads": 1,
            "dihpc.categorical.logp_entropy": 1, "dihpc.categorical.logp": 1}
    for name, n in want.items():
        fwd = _named(spans, name)
        assert len(fwd) == n and all(_inside(s, forward) for s in fwd), name
    # Backward spans only where an autograd.Function's backward opens them;
    # the behaviour side's logp takes no gradient.
    for name, n in (("dihpc.lstm.layer.kernel", L),
                    ("dihpc.categorical.logp_entropy", 1),
                    ("dihpc.categorical.logp", 0), ("dihpc.gemm.embed", 0),
                    ("dihpc.gemm.heads", 0), ("dihpc.gemm.lstm_input", 0)):
        bwd = _named(spans, name + ".bwd")
        assert len(bwd) == n, name
        assert all(_inside(s, backward) for s in bwd), name
    assert not _named(spans, "dihpc.lstm.layer.recurrent")
    assert network.lstm_fused.routes == {"kernel": L, "recurrent": 0}
    # On the CPU the wrappers run their plain versions: no launch, no span.
    assert not [s for s in spans if s[0].startswith("dihpc.kernel.")]
    layers_bwd = _named(spans, "dihpc.lstm.layer.kernel.bwd")
    dwh = _named(spans, "dihpc.gemm.lstm_dwh")
    assert len(dwh) == L
    assert all(any(_inside(d, lb) for lb in layers_bwd) for d in dwh)
    # The backward runs from the last layer to the first, after the
    # categorical head's.
    assert all(a[2] <= b[1] for a, b in zip(layers_bwd, layers_bwd[1:]))
    head_bwd = _named(spans, "dihpc.categorical.logp_entropy.bwd")[0]
    assert head_bwd[2] <= layers_bwd[0][1]


def test_recurrent_route_is_spanned():
    gen = torch.Generator().manual_seed(3)
    p = network.init_lstm_params(gen, 8, 8, 2, "LN", device="cpu")
    x = torch.randn(5, 3, 8, generator=gen, requires_grad=True)
    network.reset_route_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, _ = network.lstm_fused(p, x, remat=True)
        y.sum().backward()
    spans = _spans(prof)
    assert network.lstm_fused.routes == {"kernel": 0, "recurrent": 2}
    assert len(_named(spans, "dihpc.lstm.layer.recurrent")) == 2
    assert len(_named(spans, "dihpc.gemm.lstm_input")) == 2
    assert not [s for s in spans if s[0].endswith(".bwd")]
    assert not _named(spans, "dihpc.lstm.layer.kernel")


def _vtrace_grads(seed=5):
    gen = torch.Generator().manual_seed(seed)
    Tv, Bv, N = 6, 4, 7
    target = torch.randn(Tv, Bv, N, generator=gen, requires_grad=True)
    value = torch.randn(Tv + 1, Bv, generator=gen, requires_grad=True)
    data = ops.vtrace_data(target, torch.randn(Tv, Bv, N, generator=gen),
                           torch.randint(0, N, (Tv, Bv), generator=gen),
                           value, torch.randn(Tv, Bv, generator=gen), None)
    losses = ops.vtrace_error(data)
    total = losses.policy_loss + 0.5 * losses.value_loss \
        - 0.01 * losses.entropy_loss
    return (total.detach(), *torch.autograd.grad(total, (target, value)))


def test_vtrace_error_spans_the_categorical_head():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _vtrace_grads()
    names = [s[0] for s in _spans(prof)]
    assert names.count("dihpc.categorical.logp_entropy") == 1
    assert names.count("dihpc.categorical.logp") == 1
    assert names.count("dihpc.categorical.logp_entropy.bwd") == 1
    assert "dihpc.categorical.logp.bwd" not in names


def test_vtrace_error_gives_the_same_bits_with_the_profiler_on():
    off = _vtrace_grads()
    with profile(activities=[ProfilerActivity.CPU]):
        on = _vtrace_grads()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [3, 64])
def test_train_step_gives_the_same_bits_with_the_profiler_on(B):
    def two_steps(profiled):
        params, step, batch = _setup(B, seed=7)
        ctx = (profile(activities=[ProfilerActivity.CPU]) if profiled
               else contextlib.nullcontext())
        with ctx:
            first = step(params, batch)
            grads = {k: p.grad.clone()
                     for k, p in params.named_parameters()}
            second = step(params, batch)
        return first, second, grads, dict(params.named_parameters())

    off, on = two_steps(False), two_steps(True)
    for m_off, m_on in zip(off[:2], on[:2]):
        assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    for k in off[2]:
        assert torch.equal(off[2][k], on[2][k]), k
        assert torch.equal(off[3][k], on[3][k]), k


class _Lib:
    """A stand-in for the kernel library: every entry point returns 0."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def fake_launch(monkeypatch):
    monkeypatch.setattr(lstm_cell._build, "library",
                        lambda: types.SimpleNamespace(cdll=_Lib()))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    kernels.reset_launch_counts()
    yield
    kernels.reset_launch_counts()


def test_each_counted_launch_is_one_kernel_span(fake_launch):
    x = torch.zeros(2, 3)
    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for wrapper, dtype in ((kernels.lstm_layer_fused, torch.float32),
                               (kernels.lstm_layer_fused, torch.bfloat16),
                               (kernels.lstm_layer_bwd_v2, torch.bfloat16),
                               (kernels.lstm_layer_bwd_v1, torch.float32)):
            lstm_cell._launch(wrapper, dtype, lambda *a: 0, x.device, x, 3)
        rl_scans._launch("gae", "gae_f32", (x, x, x), 0.9, 0.8, 1, 1)
        kernels.gae.launches += 1          # as _gae_cuda counts it
    after = kernels.launch_counts()
    spans = [s[0] for s in _spans(prof)]
    counted = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    assert counted == {"lstm_layer_fused": 1, "lstm_layer_fused_bf16": 1,
                       "lstm_layer_bwd_v2_bf16": 1, "lstm_layer_bwd_v1": 1,
                       "gae": 1}
    assert sorted(s.removeprefix("dihpc.kernel.") for s in spans) == \
        sorted(counted)
