"""The LN-LSTM actor-critic learner in plain PyTorch: forward, V-trace
loss, gradient by autograd, and Adam, step by step.

Model (the IMPALA learner's network, with the LayerNorm LSTM of
arXiv:1607.06450 applied to both gate products):

    x_t  = relu(obs_t @ embed_w + embed_b)
    per layer l, per step t (h, c start at zero; gate order i, f, o, u):
      g = LN(x_t @ wx_l; gamma_x, beta_x) + LN(h @ wh_l; gamma_h, beta_h)
          + bias_l
      c = sigmoid(f) c + sigmoid(i) tanh(u);  h = sigmoid(o) tanh(c)
    logits = y @ policy_w + policy_b;  value = y @ value_w + value_b
    loss   = policy + value_coef value - entropy_coef entropy
             (reference.vtrace on the first T logits and all T+1 values)

LayerNorm: (z - mean) / sqrt(var + 1e-5) over the 4H gate columns.  Adam
(arXiv:1412.6980, with bias correction): m = b1 m + (1 - b1) g,
v = b2 v + (1 - b2) g^2, p -= lr (m / (1 - b1^k)) / (sqrt(v / (1 - b2^k))
+ eps).

Parameters are a dict from the leaf names below to float32 tensors.
"""

from __future__ import annotations

import torch

from . import vtrace
from .precision import matmul

LN_EPS = 1e-5
LN_FIELDS = ("ln_gamma_x", "ln_beta_x", "ln_gamma_h", "ln_beta_h")


def leaf_names(num_layers: int) -> list:
    """Leaf names, in the order the program's module lists them."""
    return (["embed_w", "embed_b"]
            + [f"lstm.wx.{l}" for l in range(num_layers)]
            + [f"lstm.wh.{l}" for l in range(num_layers)]
            + ["lstm.bias"] + [f"lstm.{f}" for f in LN_FIELDS]
            + ["policy_w", "policy_b", "value_w", "value_b"])


def _layer_norm(z, gamma, beta):
    mean = z.mean(-1, keepdim=True)
    var = ((z - mean) ** 2).mean(-1, keepdim=True)
    return (z - mean) / torch.sqrt(var + LN_EPS) * gamma + beta


def forward(p: dict, obs, num_layers: int, mm=torch.matmul):
    """(logits (S, B, A), value (S, B)) for obs (S, B, obs_dim)."""
    x = torch.relu(mm(obs, p["embed_w"]) + p["embed_b"])
    S, B = obs.shape[:2]
    for l in range(num_layers):
        wh = p[f"lstm.wh.{l}"]
        H = wh.shape[0]
        gx = _layer_norm(mm(x, p[f"lstm.wx.{l}"]), p["lstm.ln_gamma_x"][l],
                         p["lstm.ln_beta_x"][l])
        h = torch.zeros(B, H, dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        ys = []
        for t in range(S):
            gh = _layer_norm(mm(h, wh), p["lstm.ln_gamma_h"][l],
                             p["lstm.ln_beta_h"][l])
            i, f, o, u = torch.chunk(gx[t] + gh + p["lstm.bias"][l], 4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(u)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        x = torch.stack(ys)
    logits = mm(x, p["policy_w"]) + p["policy_b"]
    value = mm(x, p["value_w"])[..., 0] + p["value_b"][0]
    return logits, value


def loss(p: dict, batch, cfg: dict, mm=torch.matmul, rows=None):
    """The learner's total loss on `batch` (obs, actions, rewards,
    behaviour_logits).  `rows` keeps only those batch rows (a planted
    fault: part of the batch left out, the mean over the rest)."""
    obs, actions, rewards, behaviour = batch
    if rows is not None:
        obs, actions, rewards, behaviour = (
            t[:, rows] for t in (obs, actions, rewards, behaviour))
    logits, value = forward(p, obs, cfg["num_layers"], mm)
    T = actions.shape[0]
    parts = vtrace.losses(logits[:T], behaviour, actions, value, rewards,
                          cfg["gamma"], cfg["lambda"])
    return vtrace.total(*parts, cfg["value_coef"], cfg["entropy_coef"])


def train(p0: dict, batches: list, cfg: dict, precision: str = "float32",
          fault: str = "") -> dict:
    """Adam steps from `p0` (left unchanged) over `batches`, one per step.
    Returns each step's loss, the first step's gradient per leaf, and the
    change of every leaf after the last step.  `fault` plants one:
    "half_batch" takes the loss over the first half of each batch's rows."""
    opt = cfg["optimizer"]
    b1, b2 = opt["betas"]
    mm = matmul(precision)
    p = {k: v.detach().clone().float() for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"losses": [], "grad": None}
    for k, batch in enumerate(batches, start=1):
        leaves = {n: t.requires_grad_() for n, t in p.items()}
        rows = None
        if fault == "half_batch":
            rows = slice(0, batch[1].shape[1] // 2)
        total = loss(leaves, batch, cfg, mm, rows)
        grads = torch.autograd.grad(total, list(leaves.values()))
        out["losses"].append(float(total.detach()))
        if out["grad"] is None:
            out["grad"] = {n: g.detach().clone()
                           for n, g in zip(leaves, grads)}
        with torch.no_grad():
            for (n, t), g in zip(leaves.items(), grads):
                m[n].mul_(b1).add_((1 - b1) * g)
                v2[n].mul_(b2).add_((1 - b2) * g * g)
                step = (opt["lr"] * (m[n] / (1 - b1 ** k))
                        / (torch.sqrt(v2[n] / (1 - b2 ** k)) + opt["eps"]))
                p[n] = t.detach() - step
    out["delta"] = {n: p[n] - p0[n].float() for n in p}
    return out
