"""The plain reference against the port's CPU path at tiny sizes, and the
reference's lower precisions."""

import math

import pytest
import torch

from benchmark.core import compare
from benchmark.drivers import train_lstm, vtrace_loss
from benchmark.reference import impala, precision, vtrace

CFG = {"obs_dim": 8, "hidden_size": 16, "num_layers": 2, "action_dim": 5,
       "norm_type": "LN", "gamma": 0.99, "lambda": 0.95, "value_coef": 0.5,
       "entropy_coef": 0.01,
       "optimizer": {"lr": 1e-3, "betas": [0.9, 0.999], "eps": 1e-8}}
TRAFFIC = {"unroll": 6, "batch": 4, "pool": 3}


def seeded(seed=5):
    gen = torch.Generator().manual_seed(seed)
    p0 = train_lstm.init_params(CFG, gen, "cpu")
    return p0, train_lstm.batch_pool(CFG, TRAFFIC, gen, "cpu")


def test_forward_and_loss_match_the_port():
    from di_hpc_tpu_torch import models
    p0, pool = seeded()
    params = train_lstm.build_params(models, CFG, p0, "cpu")
    obs = pool[0][0]
    logits, value, _ = models.actor_critic_forward(params, obs)
    want_logits, want_value = impala.forward(p0, obs, CFG["num_layers"])
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(value, want_value, rtol=1e-5, atol=1e-6)


def test_three_adam_steps_match_the_port():
    from di_hpc_tpu_torch import models
    p0, pool = seeded()
    params = train_lstm.build_params(models, CFG, p0, "cpu")
    opt = train_lstm.make_optimizer(params, CFG)
    step = models.make_train_step(train_lstm.model_config(models, CFG), opt,
                                  CFG["gamma"], CFG["lambda"])
    losses = [float(step(params, models.TrainBatch(*b))["total_loss"])
              for b in pool]
    ref = impala.train(p0, pool, CFG)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    # The change of a leaf near 1 (LayerNorm's gain) is resolved to its
    # float32 spacing there, 1.2e-7.
    for name, p in params.named_parameters():
        torch.testing.assert_close(p.detach() - p0[name], ref["delta"][name],
                                   rtol=1e-3, atol=2.5e-7)
    gaps = compare.learner_gaps(
        {"losses": losses, "grad_norms": compare.leaf_norms(ref["grad"]),
         "delta_norms": compare.leaf_norms(
             {n: p.detach() - p0[n] for n, p in params.named_parameters()})},
        compare.reference_readings(ref))
    assert gaps["loss_gap"] < 1e-5 and gaps["delta_gap"] < 1e-4


def test_vtrace_matches_the_port():
    from di_hpc_tpu_torch import ops
    cfg = {"unroll": 12, "batch": 5, "action_dim": 7, "rho_clip_ratio": 1.0,
           "c_clip_ratio": 1.0, "rho_pg_clip_ratio": 1.0}
    gen = torch.Generator().manual_seed(3)
    target, behaviour, actions, values, rewards = vtrace_loss.make_sets(
        cfg, {"input_sets": 1, "behaviour_noise": 0.3}, gen, "cpu")[0]
    got = ops.vtrace_error(ops.vtrace_data(target, behaviour, actions,
                                           values, rewards, None))
    want = vtrace.losses(target, behaviour, actions, values, rewards, 0.99,
                         0.95)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-5, abs=1e-7)


def test_rounding_to_fewer_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.0,
                      1 + 2 ** -12])
    got = precision.round_mantissa(x, 10)
    # ties go to the even mantissa: 1 + 2^-11 -> 1, 1 + 3*2^-11 -> 1 + 2^-9
    want = torch.tensor([1.0, 1.0, 1 + 2 ** -9, -3.0, 1.0])
    assert torch.equal(got, want)
    bf = precision.round_mantissa(torch.randn(1000), 7)
    assert torch.equal(bf, bf.to(torch.bfloat16).float())


def test_lower_precision_products_differ_by_their_rounding():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    exact = a.double() @ b.double()
    for name, rel in (("tf32", 2 ** -10), ("bfloat16", 2 ** -7),
                      ("float8", 2 ** -3)):
        err = float(((precision.matmul(name)(a, b) - exact).abs().max()
                     / exact.abs().max()))
        assert rel / 64 < err < rel * 4, name
    assert precision.matmul("float32") is torch.matmul
    with pytest.raises(ValueError):
        precision.matmul("int3")


def test_fault_gaps_are_large():
    p0, pool = seeded()
    ref = compare.reference_readings(impala.train(p0, pool, CFG))
    half = compare.reference_readings(impala.train(p0, pool, CFG,
                                                   fault="half_batch"))
    gaps = compare.learner_gaps(half, ref)
    assert gaps["loss_gap"] > 1e-2 or gaps["grad_gap"] > 1e-2
    assert math.isfinite(gaps["delta_gap"])
