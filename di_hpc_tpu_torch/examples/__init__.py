"""The JAX package's examples, ported: each runs with
`python -m di_hpc_tpu_torch.examples.<name>` on the card (`--device cpu`
for the CPU), in the JAX example's configuration:

    impala_training            the V-trace train step (`--bf16`; sharded
                               over the ranks of a process group)
    impala_actor_learner       actor thread, trajectory buffer, learner
    episodic_a2c_padding       ragged episodes bucketed and padded
    ppo_training               GAE, then epochs of the clipped surrogate
    alphastar_policy_training  scatter, LN-LSTM core, V-trace + UPGO and
                               the autoregressive selection head
    r2d2_training              recurrent DQN with stored-state burn-in
    c51_training               distributional DQN
    quantile_dqn_training      QR-DQN and IQN (`--algo both|qrdqn|iqn`)
"""
