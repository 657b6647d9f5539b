"""Entry points of the port's LM stack: ``serve`` (prefill + greedy decode)
and ``train`` (the training loop)."""
