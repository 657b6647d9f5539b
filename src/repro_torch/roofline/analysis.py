"""Roofline of the port's kernels on one NVIDIA H100.

A kernel's least time on the card is the larger of two terms: the bytes it
must move (each operand read once, each result written once) at the memory
rate, and the operations it must do at the card's peak rate for their type.
The fused cluster-epoch kernel (K2, ``kernels/cluster_step.py``) does
essentially no arithmetic per byte, so its row has no operations term
(``flops_per_launch`` 0) and its bound is the bytes term alone. Flash
attention (K4) is the other extreme: its bound is its operations at the
bf16 tensor-core rate. ``bytes_per_launch`` and ``flops_per_launch`` are
analytic (from the operand and result shapes), not measured.

``Hardware`` holds one card's published rates. ``H100`` is the H100 SXM
from NVIDIA's data sheet (80 GB of HBM3 at 3.35 TB/s; 989 TFLOP/s dense
bf16 on the tensor cores; 67 TFLOP/s float32 outside them), at its full
700 W power limit. Its ``link_bw`` is 50e9 B/s, one ConnectX-7 NDR 400
Gb/s port per GPU as in a DGX H100: every axis of the dry run's 16x16 and
2x16x16 meshes spans more than one 8-GPU NVLink domain, so a ring over it
runs at the network's rate. These are data-sheet rates, not measurements.

The multi-card LM stack's three-term roofline (per (arch x shape x
mesh)), carried over from the reference:

  compute term    = FLOPs            / peak_FLOPs    (per chip)
  memory term     = bytes            / HBM_bw        (per chip)
  collective term = collective_bytes / link_bw       (per chip)

All inputs are per-chip program quantities (XLA's SPMD convention, which
the reference's records follow): the port's dry run counts rank 0's
local program (``launch.dryrun``), ``LocalProgramCounter`` below.
``parse_hlo_collectives`` reads the reference's optimized HLO text, so
both packages' records can be compared; the port's own collectives are
counted from the traced local program through the same ``_wire_bytes``.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["H100", "HW", "Hardware", "KernelRoofline", "kernel_roofline",
           "RooflineReport", "roofline_terms", "parse_hlo_collectives",
           "collective_bytes", "host_copy_bandwidth", "LocalProgramCounter"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    hbm_bw: float                 # bytes/s of device memory
    bf16_tensor_flops: float = 0.0  # dense bf16 tensor-core FLOP/s
    fp32_flops: float = 0.0       # float32 FLOP/s outside the tensor cores
    link_bw: float = 0.0          # bytes/s a chip sends over its mesh link
    hbm_per_chip: float = 0.0     # device memory capacity (fit check)


H100 = Hardware(name="NVIDIA H100 SXM (data sheet)", hbm_bw=3.35e12,
                bf16_tensor_flops=989e12, fp32_flops=67e12, link_bw=50e9,
                hbm_per_chip=80e9)
HW = H100


_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
    "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

# e.g. "bf16[16,4096,1024]{2,1,0}" or "f32[]"; tuple shapes handled by findall
_SHAPE_RE = re.compile(r"\b([a-z]\w*?)\[([\d,]*)\]")
_COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")
# "%all-gather.7 = bf16[...] all-gather(" — capture result shapes + kind
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(?[a-z][^=]*?)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")
# replica_groups={{0,1,..},{..}} or iota form replica_groups=[8,32]<=[256]...
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shapes(shape_str: str):
    out = []
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out.append(n * _DTYPE_BYTES[dtype])
    return out


def _group_size(line: str) -> int:
    m = _GROUPS_EXPLICIT_RE.search(line)
    if m:
        return m.group(1).count(",") + 1
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))   # [num_groups, group_size]
    return 2  # unknown: conservative minimum


def _wire_bytes(kind: str, shapes, n: int) -> float:
    """Per-chip ICI wire traffic for a ring implementation of the op.

    R = result bytes (for -start tuples the result is the last/largest
    component). all-gather: (n-1)/n * R; all-reduce: 2(n-1)/n * R (reduce-
    scatter + all-gather phases); reduce-scatter: (n-1) * R (operand is
    n*R); all-to-all: (n-1)/n * R; collective-permute: R.
    """
    if not shapes:
        return 0.0
    if kind == "all-gather":
        r = max(shapes)
        return (n - 1) / n * r
    r = shapes[-1]
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * r
    if kind == "reduce-scatter":
        return float(n - 1) * r
    if kind == "all-to-all":
        return (n - 1) / n * r
    return float(max(shapes))      # collective-permute


def parse_hlo_collectives(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per-chip collective wire bytes per kind, parsed from optimized HLO.

    Async ``-start``/``-done`` pairs are counted once (on the -start).
    """
    out: Dict[str, Dict[str, float]] = {
        k: {"bytes": 0.0, "count": 0} for k in _COLLECTIVE_KINDS}
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        result_shapes, kind, suffix = m.group(1), m.group(2), m.group(3)
        if suffix == "-done":
            continue
        b = _wire_bytes(kind, _shapes(result_shapes), _group_size(line))
        out[kind]["bytes"] += b
        out[kind]["count"] += 1
    return out


def collective_bytes(hlo_text: str) -> float:
    per = parse_hlo_collectives(hlo_text)
    return float(sum(v["bytes"] for v in per.values()))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # per-chip program FLOPs
    hlo_bytes: float                 # per-chip HBM traffic
    coll_bytes: float                # per-chip collective payload
    model_flops: float               # analytic 6*N*D (global, per step)
    compute_s: float
    memory_s: float
    collective_s: float
    bytes_per_device: float = 0.0    # from memory_analysis (fit check)
    hw: Hardware = HW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (global HLO FLOPs) — remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step ran at the
        max-term time: useful compute time / roofline step time."""
        t_useful = self.model_flops / (self.chips * self.hw.bf16_tensor_flops)
        return t_useful / self.step_time_s if self.step_time_s > 0 else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_ms": round(self.compute_s * 1e3, 3),
            "memory_ms": round(self.memory_s * 1e3, 3),
            "collective_ms": round(self.collective_s * 1e3, 3),
            "dominant": self.dominant,
            "step_ms": round(self.step_time_s * 1e3, 3),
            "useful_flops_frac": round(self.useful_flops_fraction, 4),
            "roofline_frac": round(self.roofline_fraction, 4),
            "bytes_per_device_gb": round(self.bytes_per_device / 1e9, 3),
        }


def roofline_terms(*, arch: str, shape: str, mesh: str, chips: int,
                   hlo_flops: float, hlo_bytes: float, coll_bytes: float,
                   model_flops: float, bytes_per_device: float = 0.0,
                   hw: Hardware = HW) -> RooflineReport:
    """All inputs are per-chip program quantities (XLA SPMD convention)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes, coll_bytes=coll_bytes,
        model_flops=model_flops,
        compute_s=hlo_flops / hw.bf16_tensor_flops,
        memory_s=hlo_bytes / hw.hbm_bw,
        collective_s=coll_bytes / hw.link_bw,
        bytes_per_device=bytes_per_device, hw=hw,
    )


# --------------------------------------------- the traced local program ----
_FUNCOL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
}


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalProgramCounter(TorchDispatchMode):
    """Counts what one rank's local program does while it is active: the
    ops DTensor runs on this rank's shards (a DTensor op is let through
    to DTensor's own dispatch first, which then runs local ops and
    functional collectives that this mode sees), so every count is per
    chip, as the reference's per-partition HLO is.

    * ``flops``: ``torch.utils.flop_counter``'s formulas over the local
      shapes (products and attention; the pointwise ops count none, as
      the matmul-dominated 6ND model assumes);
    * ``bytes``: each op's tensor inputs read once and outputs written
      once, views and collectives excluded. Unfused: an upper bound of
      the HBM traffic that XLA's fused ``bytes accessed`` reports;
    * ``collectives``: ``{kind: {"bytes", "count"}}`` in the reference's
      kinds, the wire bytes from each collective's result and group size
      through ``_wire_bytes`` (the HLO parser's ring model);
    * ``peak_bytes``: the most bytes that tensors made while the mode was
      on held at once (storages alive through any tensor or view): an
      estimate of the step's temporary memory, not XLA's buffer
      assignment.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {
            k: {"bytes": 0.0, "count": 0} for k in _COLLECTIVE_KINDS}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, list] = {}

    # DTensor's sharding propagation runs each new op once on global-shaped
    # fake tensors (``ShardingPropagator._propagate_tensor_meta_non_cached``)
    # to learn its output's shape: not part of the program. While the mode
    # is active that method is wrapped to count nothing inside it.
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        self._saved = getattr(ShardingPropagator, name)
        counter, inner = self, self._saved

        def propagating(prop, *args, **kwargs):
            counter._propagating += 1
            try:
                return inner(prop, *args, **kwargs)
            finally:
                counter._propagating -= 1

        self._propagating = 0
        setattr(ShardingPropagator, name, propagating)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._saved
        return super().__exit__(*exc)

    @property
    def collective_bytes(self) -> float:
        return float(sum(v["bytes"] for v in self.collectives.values()))

    def _drop(self, key: int) -> None:
        entry = self._live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        outs = list(_tensors(out))
        ns, _, rest = func.name().partition("::")
        opname = rest.split(".")[0]
        if ns.startswith("_c10d_functional") and opname in _FUNCOL_KINDS:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            kind = _FUNCOL_KINDS[opname]
            n = _resolve_process_group(args[-1]).size()
            self.collectives[kind]["bytes"] += _wire_bytes(
                kind, [_nbytes(t) for t in outs], n)
            self.collectives[kind]["count"] += 1
        elif not func.is_view and outs:
            packet = func._overloadpacket
            from torch.utils.flop_counter import flop_registry
            if packet in flop_registry:
                self.flops += float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            self.bytes += float(sum(_nbytes(t) for t in _tensors(args))
                                + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)
        return out


@dataclasses.dataclass
class KernelRoofline:
    kernel: str                       # e.g. "cluster_epoch_step"
    launches: int
    bytes_per_launch: float           # analytic operand+result traffic
    wall_s: float                     # total wall across all launches
    items: int = 0                    # events (or candidates) processed
    hw: Hardware = HW
    flops_per_launch: float = 0.0     # analytic operations, at the bf16
                                      # tensor-core rate
    measured_bw: float = 0.0          # host copy bandwidth (CPU baseline)

    @property
    def total_bytes(self) -> float:
        return self.launches * self.bytes_per_launch

    @property
    def achieved_bw(self) -> float:
        """Bytes actually streamed per wall second."""
        return self.total_bytes / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bound_s(self) -> float:
        """Least time on the card: the larger of the traffic at the memory
        rate and the operations at the bf16 tensor-core rate."""
        bytes_s = self.total_bytes / self.hw.hbm_bw
        if not self.flops_per_launch:
            return bytes_s
        return max(bytes_s, self.launches * self.flops_per_launch
                   / self.hw.bf16_tensor_flops)

    @property
    def bound_fraction(self) -> float:
        """Share of the roofline achieved (bound over wall time)."""
        return self.bound_s / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def host_fraction(self) -> float:
        """achieved_bw / measured host copy bandwidth (0 if unmeasured):
        the host-relative number for a run on the CPU."""
        if self.measured_bw <= 0:
            return 0.0
        return self.achieved_bw / self.measured_bw

    def row(self) -> Dict:
        return {
            "kernel": self.kernel,
            "hardware": self.hw.name,
            "launches": self.launches,
            "bytes_per_launch": int(self.bytes_per_launch),
            "total_gb": round(self.total_bytes / 1e9, 4),
            "wall_s": round(self.wall_s, 6),
            "items": self.items,
            "items_per_s": (round(self.items / self.wall_s, 1)
                            if self.wall_s > 0 else None),
            "achieved_gb_s": round(self.achieved_bw / 1e9, 4),
            "hbm_bound_frac": round(self.bound_fraction, 6),
            "host_bw_frac": round(self.host_fraction, 4),
            "bound_s": round(self.bound_s, 9),
        }


def kernel_roofline(kernel: str, *, launches: int, bytes_per_launch: float,
                    wall_s: float, items: int = 0, measured_bw: float = 0.0,
                    hw: Hardware = HW,
                    flops_per_launch: float = 0.0) -> KernelRoofline:
    return KernelRoofline(kernel=kernel, launches=launches,
                          bytes_per_launch=bytes_per_launch, wall_s=wall_s,
                          items=items, hw=hw,
                          flops_per_launch=flops_per_launch,
                          measured_bw=measured_bw)


def host_copy_bandwidth(n_bytes: int = 1 << 26, reps: int = 3) -> float:
    """Measured host memcpy bandwidth (bytes/s, read+write counted once):
    the honest local ceiling for a streaming kernel on this container."""
    import time

    import numpy as np
    src = np.ones(n_bytes // 8, np.float64)
    dst = np.empty_like(src)
    np.copyto(dst, src)                       # touch both buffers
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return src.nbytes / best
