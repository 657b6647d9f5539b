"""The reference's side of ``tools/drift_ab.py``: runs the ``arms`` text it
is given (argv 1) on the JAX reference's classes, on the CPU, with the
spec of argv 2, and writes the result as JSON to argv 3.

Needs jax and ``src/repro``: for the host, not the card's machine. The
alias ``jax.experimental.enable_x64 = jax.enable_x64`` lets the
reference's cluster package import under the installed jax.
"""
import json
import sys
import types

import jax
import jax.experimental

jax.experimental.enable_x64 = jax.enable_x64

from repro.api import Allocator, AllocatorConfig  # noqa: E402
from repro.cluster import ClusterConfig  # noqa: E402
from repro.core.allocator import AllocationPolicy  # noqa: E402
from repro.core.models import NNConfig  # noqa: E402
from repro.core.pipeline import TasqConfig  # noqa: E402
from repro.mlops import MLOpsLoop, RetrainController  # noqa: E402
from repro.serve import AllocationService  # noqa: E402
from repro.workloads import DriftSpec, TraceGenerator  # noqa: E402

if __name__ == "__main__":
    scope = {}
    exec(sys.argv[1], scope)
    api = types.SimpleNamespace(
        Allocator=Allocator, AllocatorConfig=AllocatorConfig,
        ClusterConfig=ClusterConfig, AllocationPolicy=AllocationPolicy,
        NNConfig=NNConfig, TasqConfig=TasqConfig, MLOpsLoop=MLOpsLoop,
        RetrainController=RetrainController,
        AllocationService=AllocationService, DriftSpec=DriftSpec,
        TraceGenerator=TraceGenerator, where={})
    with open(sys.argv[3], "w") as f:
        json.dump(scope["arms"](api, json.loads(sys.argv[2])), f)
