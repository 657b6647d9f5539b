"""``repro_torch`` — the TASQ reproduction in PyTorch, for NVIDIA Hopper.

A port of the JAX package ``repro``, module for module: a reader finds each
counterpart under the same path (``repro_torch.core.arepas`` for
``repro.core.arepas``, ...). Modules that are pure numpy in the reference
are copied (``workloads``, ``core.featurize``, ``core.curves``,
``core.evaluate``, ``core.models.gbdt``); the rest are PyTorch. The package
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

The slice ported so far is the paper's loop, reached through one call::

    from repro_torch.api import Allocator, AllocatorConfig, AllocationRequest
    alloc = Allocator.from_config(AllocatorConfig(family="nn"))   # on "cuda"
    decision = alloc.decide(AllocationRequest.from_dataset(
        alloc.model, alloc.pipeline.eval_set))

corpus -> bulk AREPAS augmentation (kernel K1, ``kernels/ops.py::
arepas_runtimes``, hand-written CUDA in ``csrc/skyline.cu``) -> PCC targets
-> NN / GNN / GBDT training -> features -> decoded (a, b) -> float64
allocation policy.

Devices. Every entry point (``Allocator.from_config``, ``TasqPipeline``,
``AllocationService``) takes ``device=`` and runs on ``"cuda"`` unless the
caller passes ``device="cpu"``. Asked for ``"cuda"`` without a card, it
raises ``RuntimeError``; nothing falls back to the CPU. A kernel wrapper
given a CUDA tensor launches its kernel or raises; only a CPU tensor takes
the kernel's plain PyTorch version.

Numerics. Importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: float32 products and
convolutions on the card run in full float32, as the reference computes
them, never in TF32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
