"""Entry points of the port's LM stack: ``serve`` (prefill + greedy decode)
and ``train`` (the training loop); meshes (``mesh``) and elastic restarts
(``elastic``)."""
from repro_torch.launch.elastic import ElasticController, MeshPlan
from repro_torch.launch.mesh import (make_production_mesh, make_smoke_mesh,
                                     mesh_chips)

__all__ = [
    "ElasticController",
    "MeshPlan",
    "make_production_mesh",
    "make_smoke_mesh",
    "mesh_chips",
]
