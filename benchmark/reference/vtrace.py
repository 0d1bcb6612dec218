"""V-trace losses (IMPALA, arXiv:1802.01561, eq. 1 and section 4.2) in plain
PyTorch, sequentially over time.

    rho_t = min(rho_clip, pi(a_t)/mu(a_t)),  c_t = min(c_clip, ...)
    v_s = V(x_s) + sum_t gamma^(t-s) (prod_{i<t} lambda c_i) rho_t
          (r_t + gamma V(x_{t+1}) - V(x_t)),  by the recursion
    v_s - V(x_s) = delta_s + gamma lambda c_s (v_{s+1} - V(x_{s+1}))
    policy loss  = -mean(min(pg_clip, pi/mu) (r_t + gamma v_{t+1} - V(x_t)) log pi(a_t))
    value loss   = mean((V(x_t) - v_t)^2),  entropy = mean(H(pi(.|x_t)))

v and the advantages are constants (no gradient); gradients reach the
target logits (through log pi and the entropy) and V(x_t), t < T.
`dtype` is the precision the whole computation runs in.
"""

from __future__ import annotations

import torch


def losses(logits, behaviour_logits, actions, values, rewards,
           gamma: float, lambda_: float, dtype=torch.float32,
           clips: tuple = (1.0, 1.0, 1.0)):
    """(policy_loss, value_loss, entropy) as float32 0-d tensors; logits
    (T, B, N), actions (T, B), values (T+1, B), rewards (T, B); `clips`
    bound rho, c and the policy gradient's rho."""
    x = logits.to(dtype)
    values = values.to(dtype)
    logp_all = torch.log_softmax(x, dim=-1)
    idx = actions.long()[..., None]
    logp = torch.gather(logp_all, -1, idx)[..., 0]
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
    with torch.no_grad():
        blogp = torch.gather(torch.log_softmax(behaviour_logits.to(dtype),
                                               dim=-1), -1, idx)[..., 0]
        ratio = torch.exp(logp - blogp)
        rho = torch.clamp(ratio, max=clips[0])
        c = torch.clamp(ratio, max=clips[1])
        pg_rho = torch.clamp(ratio, max=clips[2])
        v = values.detach()
        r = rewards.to(dtype)
        delta = rho * (r + gamma * v[1:] - v[:-1])
        acc = torch.zeros_like(delta[0])
        ahead = []
        for t in range(delta.shape[0] - 1, -1, -1):
            acc = delta[t] + gamma * lambda_ * c[t] * acc
            ahead.append(acc)
        vs = v[:-1] + torch.stack(ahead[::-1])
        vs_next = torch.cat([vs[1:], v[-1:]])
        adv = pg_rho * (r + gamma * vs_next - v[:-1])
    policy = -(logp * adv).mean()
    value = ((values[:-1] - vs) ** 2).mean()
    return policy.float(), value.float(), entropy.mean().float()


def total(policy, value, entropy, value_coef: float, entropy_coef: float):
    return policy + value_coef * value - entropy_coef * entropy
