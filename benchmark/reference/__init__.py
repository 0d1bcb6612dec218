"""The plain reference: plain PyTorch written from the published equations
(IMPALA's V-trace, arXiv:1802.01561; the LayerNorm LSTM, arXiv:1607.06450;
Adam, arXiv:1412.6980).  It imports nothing of the program and takes
nothing the program made: the harness hands both sides the same seeded
weights and batches."""
