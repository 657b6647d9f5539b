"""The PCC model a cell serves: weights drawn from the seed on the card,
the target scaling and the feature standardization worked out from the
seed's template pool, loaded into the port through ``PCCModel.load``.

The weights follow the reference's init law: each layer's weight
N(0, 1) / sqrt(fan_in), its bias zero, the GNN's context matrix N(0, 1) /
sqrt(D). They are drawn in one call, as float32, the type the model
serves in. No training: the paper trains on 85k jobs; a drawn model makes
the same work on the card. ``calibrate`` then scales the last layer so
that the model's two outputs over the pool's first ``CALIBRATION_JOBS``
templates have mean 0 and spread 1, as a trained model's scaled targets
do: the decoded PCCs then spread like the exact-history ones the scaling
was fitted on. (Without it the GNN, which reads raw operator features,
decodes exponents near -25 and coefficients past float32's range.)
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from tasq_bench.reference import cluster as ref_cluster
from tasq_bench.reference import featurize
from tasq_bench.reference.model import Scaler, Weights

__all__ = ["draw", "calibrate", "make_scaler", "make_standardizer",
           "program_model"]

SCALER_JOBS = 256          # pool jobs the target scaling is fitted on
CALIBRATION_JOBS = 256     # pool jobs the output scale is set on
STANDARDIZER_JOBS = 1024   # pool jobs the feature statistics come from


def _shapes(cfg: Dict) -> Tuple[List[Tuple[str, Tuple[int, ...], int]],
                                List[str], List[str]]:
    """(name, shape, fan_in) of every weight, and the MLP and GCN layer
    names, in the order they are drawn."""
    m = cfg["model"]
    out, mlp, gcn = [], [], []
    if cfg["family"] == "nn":
        dims = (featurize.JOB_FEATURE_DIM,) + tuple(m["hidden"]) + (2,)
        mlp = [f"layers.{i}" for i in range(len(dims) - 1)]
    else:
        dims = (featurize.OPERATOR_FEATURE_DIM,) + tuple(m["gcn_dims"])
        gcn = [f"gcn.{i}" for i in range(len(dims) - 1)]
        for name, (a, b) in zip(gcn, zip(dims[:-1], dims[1:])):
            out.append((name + ".weight", (b, a), a))
            out.append((name + ".bias", (b,), 0))
        D = dims[-1]
        out.append(("w_ctx", (D, D), D))
        dims = (D,) + tuple(m["head_hidden"]) + (2,)
        mlp = [f"head.layers.{i}" for i in range(len(dims) - 1)]
    for name, (a, b) in zip(mlp, zip(dims[:-1], dims[1:])):
        out.append((name + ".weight", (b, a), a))
        out.append((name + ".bias", (b,), 0))
    return out, mlp, gcn


def draw(cfg: Dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                               Weights]:
    """The model's tensors on ``device`` (float32), and the same values
    on the host in float64 for the reference."""
    specs, mlp, gcn = _shapes(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for _, s, fan in specs if fan)
    flat = torch.randn(total, generator=g, device=device,
                       dtype=torch.float32)
    tensors, at = {}, 0
    for name, shape, fan in specs:
        if fan:
            n = math.prod(shape)
            tensors[name] = flat[at:at + n].view(shape) / math.sqrt(fan)
            at += n
        else:
            tensors[name] = torch.zeros(shape, device=device)
    host = {k: v.detach().to("cpu", torch.float64)
            for k, v in tensors.items()}
    return tensors, Weights(cfg["family"], host, mlp, gcn)


def calibrate(tensors: Dict[str, torch.Tensor], w: Weights, jobs,
              mu: np.ndarray, sd: np.ndarray) -> None:
    """Scale the last layer (on the device, and its host copy) so that the
    outputs over the first ``CALIBRATION_JOBS`` of ``jobs`` have mean 0
    and spread 1 each."""
    from tasq_bench.reference import model as ref_model
    jobs = list(jobs)[:CALIBRATION_JOBS]
    if w.family == "nn":
        z = ref_model.nn_z(featurize.batch_job_features(jobs), mu, sd, w)
    else:
        z = torch.cat([ref_model.gnn_z(*(x[None] for x in featurize.pad_graph(
            j, j.num_operators())), w) for j in jobs])
    m, s = z.mean(0), z.std(0).clamp(min=1e-12)
    last = w.mlp[-1]
    for key, new in ((last + ".weight", lambda t: t / s[:, None]),
                     (last + ".bias", lambda t: (t - m) / s)):
        w.tensors[key] = new(w.tensors[key])
        tensors[key].copy_(w.tensors[key].to(tensors[key].dtype))
        w.tensors[key] = tensors[key].detach().to("cpu", torch.float64)


def make_scaler(skylines, observed) -> Scaler:
    """The PCC target scaling fitted, as the training pipeline fits it, on
    the exact-history PCCs of the first ``SCALER_JOBS`` pool jobs."""
    sk = list(skylines)[:SCALER_JOBS]
    obs = np.asarray(observed)[:SCALER_JOBS]
    peaks = np.array([int(np.max(s)) for s in sk], np.int64)
    a, b = ref_cluster.refit(sk, obs, peaks)
    y = np.maximum(-a, 1e-6)
    ra = y + np.log1p(-np.exp(-y))
    rb = np.log(np.maximum(b, 1e-9))
    return Scaler(float(np.mean(ra)), float(np.std(ra) + 1e-9),
                  float(np.mean(rb)), float(np.std(rb) + 1e-9))


def make_standardizer(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean and spread (+1e-6) of the job features of the first
    ``STANDARDIZER_JOBS`` pool jobs."""
    x = np.asarray(features, np.float64)[:STANDARDIZER_JOBS]
    return x.mean(axis=0), x.std(axis=0) + 1e-6


def program_model(cfg: Dict, tensors: Dict[str, torch.Tensor],
                  scaler: Scaler, mu: np.ndarray, sd: np.ndarray, device):
    """The port's ``NNModel`` / ``GNNModel`` serving ``tensors``."""
    from repro_torch.core.featurize import Standardizer
    from repro_torch.core.models import GNNModel, NNModel
    from repro_torch.core.models.gnn import GNN, GNNConfig
    from repro_torch.core.models.nn import MLP, NNConfig
    from repro_torch.core.pcc import PCCScaler
    m = cfg["model"]
    g = torch.Generator().manual_seed(0)
    if cfg["family"] == "nn":
        module = MLP(featurize.JOB_FEATURE_DIM, tuple(m["hidden"]),
                     generator=g)
        model = NNModel(NNConfig(hidden=tuple(m["hidden"])), device=device)
    else:
        gcfg = GNNConfig(gcn_dims=tuple(m["gcn_dims"]),
                         head_hidden=tuple(m["head_hidden"]))
        module = GNN(featurize.OPERATOR_FEATURE_DIM, gcfg, generator=g)
        model = GNNModel(gcfg, device=device)
    module.load_state_dict({k: v for k, v in tensors.items()})
    std = Standardizer.__new__(Standardizer)
    std.mu, std.sd = mu.astype(np.float32), sd.astype(np.float32)
    return model.load(module, scaler=PCCScaler(scaler.mu_a, scaler.sd_a,
                                               scaler.mu_b, scaler.sd_b),
                      std=std)
