"""Driver of the V-trace loss cells: `ops.vtrace_error` forward and its
backward to the target logits and the values, one call per step.

Set-up makes `input_sets` distinct sets of inputs on the device from the
seed (target logits (T, B, N), behaviour logits near them, int32 actions,
values (T+1, B), rewards) and warms up; the window cycles the sets.  Every
step's loss is read to the host and checked; the gradients of one step per
set, at a window position drawn from the seed, are kept and checked.  The
check runs the plain reference (reference.vtrace) once per set after the
window.
"""

from __future__ import annotations

import math

import torch

from benchmark.core.session import Session as BaseSession, limit_checks
from benchmark.reference import vtrace as ref_vtrace
from benchmark.reference.precision import no_tf32


def make_sets(cfg: dict, traffic: dict, gen: torch.Generator,
              device) -> list:
    """Each field of all sets drawn in one call: target logits normal,
    behaviour logits the target plus `behaviour_noise` times a normal,
    actions uniform, values and rewards normal."""
    S, T, B, N = (traffic["input_sets"], cfg["unroll"], cfg["batch"],
                  cfg["action_dim"])
    target = torch.randn(S, T, B, N, generator=gen, device=device)
    behaviour = target + traffic["behaviour_noise"] * torch.randn(
        S, T, B, N, generator=gen, device=device)
    actions = torch.randint(0, N, (S, T, B), generator=gen, device=device,
                            dtype=torch.int32)
    values = torch.randn(S, T + 1, B, generator=gen, device=device)
    rewards = torch.randn(S, T, B, generator=gen, device=device)
    return [(target[s], behaviour[s], actions[s], values[s], rewards[s])
            for s in range(S)]


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def clips(cfg: dict) -> tuple:
    return (cfg["rho_clip_ratio"], cfg["c_clip_ratio"],
            cfg["rho_pg_clip_ratio"])


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest entry gap over the largest reference entry."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def worst(gaps: list) -> float:
    """The largest gap; NaN where any is NaN."""
    return math.nan if any(g != g for g in gaps) else max(gaps)


class Session(BaseSession):
    def __init__(self, ctx):
        super().__init__(ctx)
        from di_hpc_tpu_torch import ops
        self.ops = ops
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.seed)
        self.sets = make_sets(cfg, traffic, gen, dev)
        ctx.mark("inputs")
        for target, _, _, values, _ in self.sets:
            target.requires_grad_()
            values.requires_grad_()
        self.samples_per_step = cfg["unroll"] * cfg["batch"]
        nsets = len(self.sets)
        self.first_step = traffic["warmup_steps"]
        draw = torch.Generator().manual_seed(ctx.seed)
        uses = torch.randint(0, traffic["sample_uses"], (nsets,),
                             generator=draw)
        # Window step i uses set i % nsets; keep the gradients of the
        # uses[s]-th use of each set s.
        self.sampled = {}
        for s in range(nsets):
            first = self.first_step + (s - self.first_step) % nsets
            self.sampled[first + int(uses[s]) * nsets] = s
        self.kept = {}
        for i in range(self.first_step):
            float(self.step(i))
            ctx.mark(f"warm-up step {i}")

    def step(self, i: int):
        s = i % len(self.sets)
        target, behaviour, actions, values, rewards = self.sets[s]
        cfg = self.ctx.config
        losses = self.ops.vtrace_error(
            self.ops.vtrace_data(target, behaviour, actions, values, rewards,
                                 None), cfg["gamma"], cfg["lambda"],
            *clips(cfg))
        total = (losses.policy_loss + cfg["value_coef"] * losses.value_loss
                 - cfg["entropy_coef"] * losses.entropy_loss)
        grads = torch.autograd.grad(total, (target, values))
        if i in self.sampled:
            self.kept[self.sampled[i]] = grads
        return total.detach()

    def reference(self, s: int, dtype=torch.float32, fault: str = ""
                  ) -> tuple:
        """(total loss, gradient of the target logits, of the values) of
        set `s` by the plain reference in `dtype`.  `fault` "half_batch"
        takes the loss over the first half of the columns alone."""
        no_tf32()
        cfg = self.ctx.config
        target, behaviour, actions, values, rewards = self.sets[s]
        logits = target.detach().clone().requires_grad_()
        value = values.detach().clone().requires_grad_()
        cols = slice(None)
        if fault == "half_batch":
            cols = slice(0, logits.shape[1] // 2)
        parts = ref_vtrace.losses(logits[:, cols], behaviour[:, cols],
                                  actions[:, cols], value[:, cols],
                                  rewards[:, cols], cfg["gamma"],
                                  cfg["lambda"], dtype, clips(cfg))
        total = ref_vtrace.total(*parts, cfg["value_coef"],
                                 cfg["entropy_coef"])
        g_logits, g_value = torch.autograd.grad(total, (logits, value))
        return float(total.detach()), g_logits, g_value

    def impostor(self, kind: str) -> dict:
        loss_gaps, grad_gaps, value_gaps = [], [], []
        for s in range(len(self.sets)):
            want, g_logits, g_value = self.reference(s)
            if kind == "control":
                got = self.reference(s, dtype=DTYPES[self.ctx.cell["control"]])
            else:
                got = self.reference(s, fault=kind)
            loss_gaps.append(abs(got[0] - want) / abs(want))
            grad_gaps.append(gap(got[1], g_logits))
            value_gaps.append(gap(got[2], g_value))
        return {"loss_gap": worst(loss_gaps),
                "logits_grad_gap": worst(grad_gaps),
                "value_grad_gap": worst(value_gaps)}

    def sample_steps(self) -> int:
        """Steps a window needs to reach every sampled step."""
        return max(self.sampled) + 1 - self.first_step

    def check(self, window: dict) -> tuple:
        limits = self.ctx.cell["limits"]
        nsets = len(self.sets)
        loss_gaps, grad_gaps, value_gaps = [], [], []
        for s in range(nsets):
            want, g_logits, g_value = self.reference(s)
            loss_gaps += [abs(got - want) / abs(want)
                          for j, got in enumerate(window["losses"])
                          if (self.first_step + j) % nsets == s]
            kept = self.kept.get(s)
            if kept is None:        # the window ended before the sample
                grad_gaps.append(math.nan)
                value_gaps.append(math.nan)
                continue
            grad_gaps.append(gap(kept[0], g_logits))
            value_gaps.append(gap(kept[1], g_value))
        failed = sum(1 for g in loss_gaps if not g <= limits["loss_gap"])
        values = {"loss_gap": worst(loss_gaps),
                  "logits_grad_gap": worst(grad_gaps),
                  "value_grad_gap": worst(value_gaps)}
        return limit_checks(values, limits), failed
