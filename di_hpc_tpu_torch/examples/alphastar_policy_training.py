"""AlphaStar-style policy training on synthetic trajectories, the port of
the JAX package's examples/alphastar_policy_training.py, in its
configuration (T=16, B=8, 32 entities of 16 features, a 32-wide entity
embedding on an 8x8 map, a 64-wide spatial summary, a 128-wide LN-LSTM
core, 8 action types, a 64-wide selection head with 6 selections, Adam
3e-4, 20 steps).

One train step composes:
 - the entity encoder, then `network.scatter_connection` ("add") of each
   entity's embedding at its (y, x), over all T+1 steps at once;
 - the LN-LSTM core over the trajectory (`network.lstm_fused`: on the card
   TPU kernel 1 forward with the stash, kernel 5 backward at B < 64);
 - the action-type head trained with `ops.vtrace_error` (kernels 2 and 3)
   and `ops.upgo_loss` (kernels 12 and 11) on shared clipped importance
   weights;
 - the autoregressive selected-units head (`models.select_entities`) on
   the final core state, trained with a REINFORCE term on its selection
   log-probs up to each row's "end".

The JAX example samples the selections with a key; here the loss samples
with a torch.Generator on the inputs' device when one is given, and is
greedy without one.  Batches are drawn from a CPU torch.Generator seeded as
the JAX example seeds its key.

Run: python -m di_hpc_tpu_torch.examples.alphastar_policy_training
     [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from di_hpc_tpu_torch import models, network, ops
from di_hpc_tpu_torch.models import AlphaStarParams as Params

LR = 3e-4
SEED = 0


def init_params(generator: torch.Generator, De, N, H, W, F, Hc, A, Hs,
                device="cuda") -> Params:
    """The JAX example's init scales (normal / sqrt(fan_in) weights, a
    uniform LN-LSTM core with LN at identity, the selection head of
    init_entity_selection), drawn on the CPU from `generator`."""
    def normal(*shape):
        return (torch.randn(shape, generator=generator)
                / shape[0] ** 0.5).to(device)

    ent_w, spatial_w = normal(De, N), normal(N * H * W, F)
    core = network.LSTMWeights(network.init_lstm_params(
        generator, N + F, Hc, 1, "LN", device=device))
    act_w, val_w, ae_w = normal(Hc, A), normal(Hc), normal(Hc, N)
    sel = models.init_entity_selection(generator, N, Hs, N, device)
    return Params(ent_w, torch.zeros(N, device=device), spatial_w, core,
                  act_w, val_w, ae_w, sel)


def synthetic_batch(generator: torch.Generator, T, B, M, De, H, W, A,
                    device="cuda") -> dict:
    """The JAX example's trajectory batch (:72-80): entity features, their
    map locations, actions, behaviour logits, rewards * 0.1 and each row's
    entity count in [M/2, M]; drawn on the CPU from `generator` and moved
    to `device`."""
    def ints(hi, *shape, lo=0):
        return torch.randint(lo, hi, shape, generator=generator)

    batch = {"ent_feats": torch.randn((T + 1, B, M, De), generator=generator),
             "locations": torch.stack([ints(H, T + 1, B, M),
                                       ints(W, T + 1, B, M)], dim=-1),
             "actions": ints(A, T, B),
             "behaviour": torch.randn((T, B, A), generator=generator),
             "rewards": torch.randn((T, B), generator=generator) * 0.1,
             "entity_num": ints(M + 1, B, lo=M // 2)}
    return {k: v.to(device) for k, v in batch.items()}


def alphastar_loss(p: Params, x: dict, H: int, W: int, max_selections: int,
                   generator=None):
    """The example's loss_fn (:82-129) on batch x with an (H, W) map: the
    selections sampled with `generator` (on the inputs' device), greedy
    without one.  Returns (total, the example's metrics, the selections
    (S, B), each row's entity_num marking its "end")."""
    T1, B, M = x["ent_feats"].shape[:3]
    N = p.ent_w.shape[1]
    emb = torch.tanh(x["ent_feats"] @ p.ent_w + p.ent_b)         # (T+1,B,M,N)
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
        entity_num, ae0, (zeros, zeros), max_selections, generator)
    # Steps after a row's first "end" are forced repeats of the sentinel:
    # no learning signal there.
    is_end = (selected == entity_num[None, :]).to(torch.int32)
    after_end = (torch.cumsum(is_end, dim=0) - is_end) > 0
    sel_logp = torch.where(after_end, torch.zeros((), device=y.device),
                           ops.logp(sel_logits, selected))         # (S, B)
    adv = (rewards.sum(dim=0) - value[0]).detach()
    sel_loss = -torch.mean(adv * sel_logp.sum(dim=0))

    total = (vt.policy_loss + 0.5 * vt.value_loss - 0.01 * vt.entropy_loss
             + 0.2 * upgo + 0.1 * sel_loss)
    return total, {"total": total, "pg": vt.policy_loss,
                   "value": vt.value_loss, "upgo": upgo,
                   "select": sel_loss}, selected


def train_step(p: Params, optimizer, batch: dict, H: int, W: int,
               max_selections: int, generator=None):
    """One train step: the loss, backward and the optimizer step.  Returns
    the metrics (detached) and the gradients by parameter name."""
    optimizer.zero_grad()
    total, metrics, _ = alphastar_loss(p, batch, H, W, max_selections,
                                       generator)
    total.backward()
    grads = {k: v.grad.clone() for k, v in p.named_parameters()}
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}, grads


def main(steps: int = 20, T: int = 16, B: int = 8, M: int = 32, De: int = 16,
         N: int = 32, H: int = 8, W: int = 8, F: int = 64, Hc: int = 128,
         A: int = 8, Hs: int = 64, max_selections: int = 6,
         device="cuda") -> Params:
    gen = torch.Generator().manual_seed(SEED)
    params = init_params(gen, De, N, H, W, F, Hc, A, Hs, device)
    optimizer = torch.optim.Adam(params.parameters(), lr=LR)
    select_gen = torch.Generator(device=device).manual_seed(SEED)
    for i in range(steps):
        batch = synthetic_batch(gen, T, B, M, De, H, W, A, device)
        m, _ = train_step(params, optimizer, batch, H, W, max_selections,
                          select_gen)
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:3d}  total={float(m['total']):+.4f}  "
                  f"pg={float(m['pg']):+.4f}  value={float(m['value']):.4f}"
                  f"  upgo={float(m['upgo']):+.4f}"
                  f"  select={float(m['select']):+.4f}", flush=True)
    return params


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.steps, device=args.device)
