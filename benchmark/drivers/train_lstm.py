"""Driver of the LN-LSTM learner cells: `models.make_train_step` (the
unsharded V-trace step with Adam) on one card.

Set-up makes the weights and a pool of distinct batches on the device from
the seed, builds the program's parameters, optimizer and step once, and
drives that step through its first `checked_steps` steps on pool batches
0, 1, 2, ... through the window's own call; the window then goes on
cycling the pool.  The check runs the plain reference (reference.impala)
from the same weights over the same batches after the window, and compares
each step's loss, the first gradient as Adam holds it after step 1 (its
first moment over 1 - beta1) and the parameters' change after the checked
steps, as norms by leaf (core.compare).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark.core import compare
from benchmark.core.session import Session as BaseSession, limit_checks
from benchmark.reference import impala
from benchmark.reference.precision import no_tf32

GAPS = ("loss_gap", "grad_gap", "delta_gap")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Seeded float32 weights, in two draws on `device`: the embedding and
    heads normal / sqrt(fan-in), the LSTM's matrices and bias uniform in
    +-1/sqrt(H), LayerNorm at identity, head biases zero."""
    O, H, L, A = (cfg[k] for k in ("obs_dim", "hidden_size", "num_layers",
                                   "action_dim"))
    G = 4 * H
    normal = torch.randn(O * H + H * A + H, generator=gen, device=device)
    embed_w, policy_w, value_w = normal.split([O * H, H * A, H])
    uniform = torch.rand(2 * L * H * G + L * G, generator=gen,
                         device=device) * (2 / math.sqrt(H)) - 1 / math.sqrt(H)
    parts = uniform.split([H * G] * (2 * L) + [L * G])
    p = {"embed_w": embed_w.view(O, H) / math.sqrt(O),
         "embed_b": torch.zeros(H, device=device)}
    for l in range(L):
        p[f"lstm.wx.{l}"] = parts[l].view(H, G)
    for l in range(L):
        p[f"lstm.wh.{l}"] = parts[L + l].view(H, G)
    p["lstm.bias"] = parts[2 * L].view(L, G)
    for f in impala.LN_FIELDS:
        fill = 1.0 if "gamma" in f else 0.0
        p[f"lstm.{f}"] = torch.full((L, G), fill, device=device)
    p["policy_w"] = policy_w.view(H, A) / math.sqrt(H)
    p["policy_b"] = torch.zeros(A, device=device)
    p["value_w"] = value_w.view(H, 1) / math.sqrt(H)
    p["value_b"] = torch.zeros(1, device=device)
    return {n: p[n].contiguous() for n in impala.leaf_names(L)}


def batch_pool(cfg: dict, traffic: dict, gen: torch.Generator,
               device) -> list:
    """`pool` distinct batches (obs (T+1, B, O), actions (T, B) int32,
    rewards (T, B), behaviour logits (T, B, A)), each field of all of them
    drawn in one call."""
    T, B, P = traffic["unroll"], traffic["batch"], traffic["pool"]
    O, A = cfg["obs_dim"], cfg["action_dim"]
    obs = torch.randn(P, T + 1, B, O, generator=gen, device=device)
    actions = torch.randint(0, A, (P, T, B), generator=gen, device=device,
                            dtype=torch.int32)
    rewards = torch.randn(P, T, B, generator=gen, device=device)
    behaviour = torch.randn(P, T, B, A, generator=gen, device=device)
    return [(obs[i], actions[i], rewards[i], behaviour[i]) for i in range(P)]


def build_params(models, cfg: dict, p0: dict, device):
    """The program's parameter module from the seeded tensors (copies)."""
    from di_hpc_tpu_torch.network import LSTMParams
    L = cfg["num_layers"]
    c = lambda n: p0[n].detach().clone()
    lstm = LSTMParams(tuple(c(f"lstm.wx.{l}") for l in range(L)),
                      tuple(c(f"lstm.wh.{l}") for l in range(L)),
                      c("lstm.bias"), *(c(f"lstm.{f}")
                                        for f in impala.LN_FIELDS))
    return models.ActorCriticParams(c("embed_w"), c("embed_b"), lstm,
                                    c("policy_w"), c("policy_b"),
                                    c("value_w"), c("value_b"))


def compute_dtype(traffic: dict):
    """None for float32, else the step's compute dtype."""
    return None if traffic["dtype"] == "float32" else DTYPES[traffic["dtype"]]


def model_config(models, cfg: dict):
    return models.ActorCriticConfig(cfg["obs_dim"], cfg["hidden_size"],
                                    cfg["num_layers"], cfg["action_dim"],
                                    cfg["norm_type"])


def make_optimizer(params, cfg: dict):
    opt = cfg["optimizer"]
    return torch.optim.Adam(params.parameters(), lr=opt["lr"],
                            betas=tuple(opt["betas"]), eps=opt["eps"])


class Session(BaseSession):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.setup()

    def reseed(self, seed: int) -> None:
        """The set-up again, from another seed (for calibration)."""
        self.ctx.seed = seed
        self.setup()

    def setup(self) -> None:
        from di_hpc_tpu_torch import models
        self._refs = {}
        ctx = self.ctx
        cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(ctx.seed)
        self.p0 = init_params(cfg, gen, dev)
        self.pool = batch_pool(cfg, traffic, gen, dev)
        self.feed = self.local(self.pool)
        ctx.mark("weights and batches")
        self.samples_per_step = traffic["unroll"] * traffic["batch"]
        self.params = build_params(models, cfg, self.p0, dev)
        self.optimizer = make_optimizer(self.params, cfg)
        self.train_step = self.make_step(models, model_config(models, cfg))
        self.TrainBatch = models.TrainBatch
        ctx.mark("program built")
        self.readings = self.checked_steps(traffic["checked_steps"])
        n = traffic["checked_steps"]
        self.warm_s = []
        for i in range(n, n + traffic["warmup_steps"]):
            start = time.perf_counter()
            float(self.step(i))
            self.warm_s.append(time.perf_counter() - start)
        ctx.mark("warm-up")
        self.first_step = n + traffic["warmup_steps"]

    def make_step(self, models, model_cfg):
        """The program's step: the unsharded `make_train_step`."""
        cfg = self.ctx.config
        return models.make_train_step(
            model_cfg, self.optimizer, cfg["gamma"], cfg["lambda"],
            cfg["value_coef"], cfg["entropy_coef"],
            compute_dtype=compute_dtype(self.ctx.traffic))

    def local(self, pool: list) -> list:
        """The batches this process feeds its step (all of each)."""
        return pool

    def step(self, i: int):
        batch = self.TrainBatch(*self.feed[i % len(self.feed)])
        return self.train_step(self.params, batch)["total_loss"]

    def named(self) -> dict:
        return dict(self.params.named_parameters())

    def checked_steps(self, n: int) -> dict:
        """Runs steps 0..n-1 and reads the loss of each, the first gradient
        from Adam's state after step 0 and each leaf's change after the
        last."""
        beta1 = self.ctx.config["optimizer"]["betas"][0]
        losses, grad_norms = [], None
        for i in range(n):
            losses.append(float(self.step(i)))
            self.ctx.mark(f"checked step {i}")
            if i == 0:
                state = self.optimizer.state
                grad_norms = {
                    k: (compare.leaf_norms({k: state[p]["exp_avg"]})[k]
                        / (1 - beta1)) if "exp_avg" in state[p]
                    else math.nan for k, p in self.named().items()}
        delta = compare.leaf_norms({k: p.detach() - self.p0[k]
                                    for k, p in self.named().items()})
        return {"losses": losses, "grad_norms": grad_norms,
                "delta_norms": delta}

    def free(self) -> None:
        del self.params, self.optimizer, self.train_step, self.feed
        self.pool = self.pool[:self.ctx.traffic["checked_steps"]]
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", fault: str = "") -> dict:
        key = (precision, fault)
        if key not in self._refs:
            no_tf32()
            out = impala.train(self.p0,
                               self.pool[:len(self.readings["losses"])],
                               self.ctx.config, precision, fault)
            self._refs[key] = compare.reference_readings(out)
        return self._refs[key]

    def check(self, window: dict) -> tuple:
        gaps = compare.learner_gaps(self.readings, self.reference())
        failed = sum(1 for x in window["losses"] if not math.isfinite(x))
        limits = self.ctx.cell["limits"]
        return (limit_checks({k: gaps[k] for k in GAPS if k in limits},
                             limits), failed)

    def detail(self) -> dict:
        """Each side's losses and the leaves' norms, for calibration."""
        return {"program": self.readings,
                **{"/".join(k): v for k, v in self._refs.items()}}

    def impostor(self, kind: str) -> dict:
        if kind == "control":
            other = self.reference(precision=self.ctx.cell["control"])
        elif kind in ("tf32", "bfloat16", "float8"):
            other = self.reference(precision=kind)
        else:
            other = self.reference(fault=kind)
        gaps = compare.learner_gaps(other, self.reference())
        return {k: gaps[k] for k in GAPS}
