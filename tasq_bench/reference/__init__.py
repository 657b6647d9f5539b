"""The benchmark's plain reference: numpy and plain PyTorch on the host.

Nothing here imports ``jax``, the JAX package or the port. It works out
again, from the benchmark's own inputs and weights, what the program
derives from them: features (``featurize``, a frozen copy), the PCC
model's decoded parameters (``model``), the float64 allocation policy
(``policy``), AREPAS runtimes (``arepas``) and the cluster control's
epoch step, elastic resize and cache refit (``cluster``).
"""
