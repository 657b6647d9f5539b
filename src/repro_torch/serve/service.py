"""AllocationService: features to token decisions through pre-built
executables on one device, and the sharded fabric on one device or a
shard mesh.

The deploy/allocate stage of the paper (§2.2) as an online service: a
trained ``PCCModel`` plus an ``AllocationPolicy`` become a batch function

    model inputs (B, ...) -> scaled z -> PCCScaler.decode -> (a, b)
                          -> ops.policy_decide -> tokens (B,)

The decode runs in float32, its (a, b) are cast to float64, and the policy
runs in float64 — in that order, as the reference's fused executable does —
so the tokens are the numpy ``choose_tokens`` oracle's on the same decoded
parameters (up to ``pow``'s last bit; see ``core/allocator.py``). Every
stage takes its policy from ``kernels.ops.policy_decide``: on the card
that is one launch of kernel K6 (``csrc/cluster_step.cu``), bitwise the
torch twin ``choose_tokens_priced_torch`` plus the runtime, which is the
plain version and the CPU path. Host-only models (GBDT) predict (a, b) on
the host and share the device policy stage.

The one entry point is ``decide(AllocationRequest, DecisionContext) ->
AllocationDecision``: the history path (request carries ``a``/``b``), the
model path (request carries ``model_in``) and the priced path (context
carries ``price``). Batches beyond ``MAX_BATCH`` are served in chunks, and
each chunk is padded to a power-of-two bucket.

Executables. Each decision stage is a module-level factory
(``make_policy_decide`` & co.) and is served through a
``DecisionExecutable`` bound to one padded input signature, cached in the
replica's ``ReplicaState`` under the reference's keys
(``("policy" | "priced", Bp, observed?, policy)``,
``("fused", model.cache_key, shape_sig, observed?, policy)`` and the
fabric's ``sharded_*`` twins), so ``stats["compiles"]`` counts the same
builds as the reference's jit cache. On a CUDA device an executable is a
``torch.cuda.CUDAGraph`` captured once for its key, with static input and
output buffers: a decide makes one host-to-device copy into the static
inputs, replays the graph and makes one copy out of a stacked float64
output; its policy is one K6 node, where the torch twin would be ~500
element-wise kernels. A capture that fails (a host sync inside a stage,
say) raises; there is no quiet switch to the eager stage. On a CPU device
the caller asked for the host, and the executable is the eager stage
bound to its padded shape. ``serve/aot.py`` builds the whole grid before
traffic.

``ShardedAllocationService`` puts K replicas of one trained model behind
the same protocol: ``DecisionContext.shard_of`` tags each row with a shard
rank, rows are stacked into a (K, Bp) block (``Bp`` the bucket of the
fullest shard) and one executable decides the block. The reference maps
the per-shard stage over the shard axis with ``vmap``/``shard_map``. On
one device the port runs the block through the per-shard stage flattened
to (K * Bp,) rows: every step of the policy stages is element-wise in the
rows, so each row's decision is the one a single-shard service fed that
shard's partition gives. On a ``("shard",)`` mesh of K ranks
(``launch.mesh.make_allocation_mesh``) every rank runs the same host code,
as every process runs the same program under multi-controller jax: it
stacks the block, decides its own shard's (Bp, ...) rows through the
executable a single-shard service runs at bucket Bp, and gathers the K
ranks' outputs over the mesh's group (on the card under NCCL, through host
memory under gloo). Each rank then decides exactly as K independent
single-shard services fed the routed partitions, the fused stage too,
whose float32 products the one-device path takes over K * Bp rows at once.

The pre-protocol method matrix (``allocate_params`` /
``allocate_params_priced`` / ``allocate_batch`` / ``allocate_dataset``,
and the fabric's twins) survives as deprecation shims over ``decide``
(``repro_torch.api._compat``), returning the legacy ``AllocationResult``.

Counters. ``stats`` holds ``compiles`` (executables built on the hot
path), ``calls`` (decision-stage invocations), ``queries`` (rows decided)
and ``executables_retired`` (dropped by ``invalidate`` on a model swap),
per service and per fabric replica, as the reference's ``ReplicaState``
does. Every ``decide`` opens a ``service.decide`` / ``fabric.decide`` span
on the ``obs`` bundle, records its latency in ``decision_compile_s`` (a
call that built, or waited out another thread's build of, an executable)
or ``decision_latency_s`` (the steady state), and offers its rows to the
flight recorder. Each executable call counts its read-back as one
host-to-card sync (``device_syncs.decide``, ``device_wait_s.decide``);
with the tracer on, a CUDA graph's replay is timed with a pair of CUDA
events, and the span carries the replays' device time as ``device_ms``.
Every model-path stage, of the service and of the fabric, counts its
work from the host-side inputs: ``model_rows`` (rows the model decides)
and, for a graph model, ``model_nodes`` (their real operators),
``model_adj_entries`` (the sum of n squared over those rows, n a row's
operators) and ``model_adj_slots`` (N squared for every row the
executable computes, its batch padding and the fabric's K x Bp block
included, N the padded node count). These four are written only on a
bundle whose metrics record, so an untraced decide does no added work.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api._compat import warn_deprecated
from repro_torch.api.types import (AllocationDecision, AllocationRequest,
                                   DecisionContext, Provenance)
from repro_torch.core.allocator import AllocationPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import NULL_METRICS, NULL_OBS, Obs
from repro_torch.serve.batching import batch_bucket, pad_to, shard_positions

__all__ = ["AllocationResult", "AllocationService", "DecisionExecutable",
           "MeshExecutable", "ReplicaState", "ShardedAllocationService",
           "make_fused_decide", "make_policy_decide", "make_priced_decide",
           "make_sharded_fused_per_shard", "make_sharded_policy_per_shard"]

F64, I64, F32 = torch.float64, torch.int64, torch.float32


class _Dispatch:
    """What the executables that one decide runs report back to it: the
    bundle their host waits count into, and the summed device time of
    their timed graph replays (None until one is timed)."""

    __slots__ = ("obs", "device_ms")

    def __init__(self, obs: Obs):
        self.obs = obs
        self.device_ms = None


# the decide under way on each thread (None outside a decide, as in the
# warm calls of ``serve/aot.py``)
_CURRENT = threading.local()


def _current_dispatch() -> Optional[_Dispatch]:
    return getattr(_CURRENT, "call", None)


@dataclasses.dataclass
class AllocationResult:
    """Legacy result type of the pre-protocol method matrix (the shims still
    return it); new code consumes ``repro_torch.api.AllocationDecision``."""
    tokens: np.ndarray        # (B,) int64 allocation decisions
    a: np.ndarray             # (B,) decoded PCC exponent
    b: np.ndarray             # (B,) decoded PCC coefficient
    runtime: np.ndarray       # (B,) predicted runtime at the chosen tokens


def _as_result(decision: AllocationDecision) -> AllocationResult:
    return AllocationResult(tokens=decision.tokens, a=decision.a,
                            b=decision.b, runtime=decision.runtime)


# --------------------------------------------------------------- stages --
# Module-level factories for the decision stages. The lazy build functions below
# bind them to a padded shape on first request; the AOT warmup
# (``repro_torch.serve.aot``) builds the *same* functions at startup — one
# definition, so the two paths are bitwise-identical by construction.

def make_policy_decide(policy: AllocationPolicy, with_observed: bool):
    def decide(a, b, observed):
        return ops.policy_decide(a, b, policy,
                                 observed=observed if with_observed else None)

    return decide


def make_priced_decide(policy: AllocationPolicy, with_observed: bool):
    def decide(a, b, price, observed):
        return ops.policy_decide(a, b, policy, price,
                                 observed if with_observed else None)

    return decide


def make_fused_decide(model, policy: AllocationPolicy, with_observed: bool):
    scaler = model.scaler

    def fused(model_in, observed):
        z = model.serve_apply(model_in)
        a, b = scaler.decode(z)                            # float32
        toks, rt = ops.policy_decide(
            a.to(F64), b.to(F64), policy,
            observed=observed if with_observed else None)
        return toks, a, b, rt

    return fused


def make_sharded_policy_per_shard(policy: AllocationPolicy,
                                  with_observed: bool, priced: bool):
    def per_shard(a, b, price, obs):
        # exactly the single-shard policy stage on a (Bp,) block
        return ops.policy_decide(a, b, policy, price if priced else None,
                                 obs if with_observed else None)

    return per_shard


def make_sharded_fused_per_shard(model, policy: AllocationPolicy,
                                 with_observed: bool):
    # the single-shard fused stage: identical math on one replica's rows
    return make_fused_decide(model, policy, with_observed)


def _tree_map(fn, x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    return fn(x)


def _over_shards(per_shard):
    """Lift a per-shard stage over a (K, Bp, ...) block: the block's rows
    go through the stage flattened to (K * Bp, ...), which is the per-shard
    math because every step of the stage is element-wise in the rows."""
    def run(*args):
        lead = next(t for t in args if isinstance(t, torch.Tensor)).shape[:2]
        flat = [_tree_map(lambda t: t.reshape((-1,) + t.shape[2:]), x)
                for x in args]
        return tuple(o.reshape(lead + o.shape[1:]) for o in per_shard(*flat))

    return run


# ----------------------------------------------------------- executables --
# An input spec per positional stage argument: None (absent), a
# (shape, dtype) pair, or {name: (shape, dtype)} for model inputs.
Spec = Union[None, Tuple[Tuple[int, ...], torch.dtype],
             Dict[str, Tuple[Tuple[int, ...], torch.dtype]]]

_ALIGN = 16


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _zeros(specs: Sequence[Spec]) -> List:
    """Host arguments of zeros matching ``specs``."""
    def one(s):
        if s is None:
            return None
        if isinstance(s, dict):
            return {k: one(v) for k, v in s.items()}
        return torch.zeros(s[0], dtype=s[1]).numpy()
    return [one(s) for s in specs]


def _one_shard(spec: Spec) -> Spec:
    """A stacked (K, Bp, ...) spec as one shard's (Bp, ...)."""
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {k: _one_shard(v) for k, v in spec.items()}
    return tuple(spec[0][1:]), spec[1]


def _leaves(specs: Sequence[Spec]):
    """(arg index, name or None, shape, dtype) for every input tensor."""
    for i, s in enumerate(specs):
        if isinstance(s, dict):
            for k in sorted(s):
                yield i, k, tuple(s[k][0]), s[k][1]
        elif s is not None:
            yield i, None, tuple(s[0]), s[1]


class DecisionExecutable:
    """One decision stage bound to one padded input signature.

    ``exe(*host_args)`` takes numpy arrays (or dicts of them, or None)
    matching ``specs`` and returns the stage's outputs as numpy arrays at
    the padded shape.

    On a CUDA device the stage is captured once into a ``CUDAGraph`` (in
    the replica's shared memory pool) over static inputs that are views of
    one device byte buffer; its outputs are stacked into one float64
    buffer inside the graph (tokens and float32 parameters convert
    exactly). A call fills a pinned host twin of the input buffer, copies
    it over once, replays the graph and copies the stacked output back
    once. The capture runs in ``"thread_local"`` error mode, so another
    thread's launches (a serving-plane worker replaying a different key)
    neither break it nor are refused by it. Replays hold the replica's
    ``replay_lock``: graphs that share one memory pool may reuse each
    other's temporaries, so no two of them may run at once, and the lock
    also keeps two workers off one graph's static buffers.

    Each replay adds the K6 launches its capture recorded to
    ``kernels.ops.launch_counts()``, as the eager stage's launches count.

    On a CPU device the executable is the eager stage: inputs become
    tensors, the stage runs, outputs come back; nothing is shared between
    calls.

    Inside a decide, the call counts its read-back (the synchronize, on
    the card) as the decide's host-to-card sync, and, with the decide's
    tracer on, times the graph's replay with a pair of CUDA events made on
    the first such call.
    """

    def __init__(self, stage: Callable, specs: Sequence[Spec],
                 device: torch.device, replica: "ReplicaState"):
        self.stage = stage
        self.specs = tuple(specs)
        self.device = torch.device(device)
        self.graph = None
        self._events = None
        if self.device.type == "cuda":
            self._lock = replica.replay_lock
            self._capture(replica.graph_pool())

    # ------------------------------------------------------------ helpers --
    def zeros(self) -> List:
        """Host arguments of zeros matching the specs (for warm calls)."""
        return _zeros(self.specs)

    def _args(self, leaf) -> List:
        """Stage arguments built from ``leaf(i, name, shape, dtype)``."""
        args: List = [None] * len(self.specs)
        for i, k, shape, dtype in _leaves(self.specs):
            t = leaf(i, k, shape, dtype)
            if k is None:
                args[i] = t
            else:
                args[i] = {**(args[i] or {}), k: t}
        return args

    # ------------------------------------------------------------- capture --
    def _capture(self, pool) -> None:
        dev = self.device
        offsets, off = {}, 0
        for i, k, shape, dtype in _leaves(self.specs):
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            offsets[(i, k)] = (off, nbytes)
            off += -(-nbytes // _ALIGN) * _ALIGN
        size = max(off, _ALIGN)
        self._d_in = torch.zeros(size, dtype=torch.uint8, device=dev)
        self._h_in = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        h_np = self._h_in.numpy()

        def dview(i, k, shape, dtype):
            o, n = offsets[(i, k)]
            return self._d_in[o:o + n].view(dtype).view(shape)

        def hview(i, k, shape, dtype):
            o, n = offsets[(i, k)]
            return h_np[o:o + n].view(_np_dtype(dtype)).reshape(shape)

        self._host_views = [(i, k, hview(i, k, shape, dtype))
                            for i, k, shape, dtype in _leaves(self.specs)]
        args = self._args(dview)
        # one eager pass on a side stream first, as CUDA graph capture
        # wants: libraries initialise their handles and workspaces outside
        # the graph
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.inference_mode():
            outs = self.stage(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        self._out_dtypes = [o.dtype for o in outs]
        recorded = ops.recorded_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(
                graph, pool=pool, capture_error_mode="thread_local"):
            outs = self.stage(*args)
            self._d_out = torch.stack([o.to(F64) for o in outs])
        # the K6 launches the capture recorded run at every replay
        self._k6_launches = ops.recorded_launches() - recorded
        self._h_out = torch.empty(self._d_out.shape, dtype=F64,
                                  pin_memory=True)
        self.graph = graph

    # ---------------------------------------------------------------- call --
    def __call__(self, *host_args) -> List[np.ndarray]:
        call = _current_dispatch()
        o = NULL_OBS if call is None else call.obs
        if self.graph is None:
            return self._eager(host_args, o)
        with self._lock:
            events = self.timing_events(call)
            self._replay(host_args, events)
            self._h_out.copy_(self._d_out, non_blocking=True)
            with o.device_wait("decide"):
                torch.cuda.current_stream(self.device).synchronize()
            self.add_device_ms(call, events)
            return self.split(self._h_out.numpy())

    def timing_events(self, call: Optional[_Dispatch]):
        """The (start, end) CUDA events that time a replay, where the
        decide under way traces; else None. The caller holds ``_lock``."""
        if call is None or not call.obs.tracer.enabled:
            return None
        if self._events is None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        return self._events

    @staticmethod
    def add_device_ms(call: Optional[_Dispatch], events) -> None:
        """Add a timed replay's device milliseconds to its decide; the
        events are complete after the read-back's synchronize."""
        if events is not None:
            call.device_ms = ((call.device_ms or 0.0)
                              + events[0].elapsed_time(events[1]))

    def _replay(self, host_args, events=None) -> None:
        """Copy the host arguments into the static inputs and replay the
        graph, between ``events`` where given; its stacked output is then
        in ``_d_out``. The caller holds ``_lock``."""
        for i, k, view in self._host_views:
            x = host_args[i] if k is None else host_args[i][k]
            np.copyto(view, x, casting="unsafe")
        self._d_in.copy_(self._h_in, non_blocking=True)
        if events is None:
            self.graph.replay()
        else:
            events[0].record()
            self.graph.replay()
            events[1].record()
        ops.count_replayed(self._k6_launches)

    def split(self, stacked: np.ndarray) -> List[np.ndarray]:
        """The graph's stacked float64 outputs, (n_out, ...) along the
        first axis, as the stage's outputs at their own dtypes."""
        return [stacked[j].astype(_np_dtype(dt))
                for j, dt in enumerate(self._out_dtypes)]

    @torch.inference_mode()
    def _eager(self, host_args, o: Obs) -> List[np.ndarray]:
        def leaf(i, k, shape, dtype):
            x = host_args[i] if k is None else host_args[i][k]
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                                 dtype)
        outs = self.stage(*self._args(leaf))
        with o.device_wait("decide"):
            return [t.numpy() for t in outs]


class MeshExecutable:
    """A sharded (K, Bp) stage on a ``("shard",)`` mesh of K ranks.

    ``exe(*host_args)`` takes the stacked (K, Bp, ...) host arguments every
    rank holds alike, decides this rank's shard — row ``rank`` of each
    argument — through ``inner``, the single-shard executable at (Bp, ...),
    and gathers the K ranks' outputs into (K, Bp, ...) over the mesh's
    group: one collective a call, of all outputs stacked in float64 (the
    tokens and the float32 parameters convert exactly).

    The gather goes by the group's backend. Under NCCL it runs on the card,
    on ``inner``'s graph output, inside its replay lock. Under gloo (ranks
    on the CPU, or several ranks sharing one card) the outputs come to the
    host first and are gathered there. A failing collective raises; there
    is no quiet switch to the one-device path. Every rank must make the
    same sequence of calls, as SPMD ranks do.
    """

    def __init__(self, inner: DecisionExecutable, specs: Sequence[Spec],
                 mesh):
        self.inner = inner
        self.specs = tuple(specs)
        self.group = mesh.get_group("shard")
        self.rank = mesh.get_local_rank("shard")
        self.n = mesh.size()
        self.on_card = dist.get_backend(self.group) == "nccl"
        if self.on_card and inner.graph is None:
            raise ValueError("a NCCL mesh needs its stage on the card")
        self._gather = getattr(dist, "all_gather_single",
                               dist.all_gather_into_tensor)
        if self.on_card:
            shape = (self.n * inner._d_out.shape[0],) + inner._d_out.shape[1:]
            self._d_all = torch.empty(shape, dtype=F64, device=inner.device)
            self._h_all = torch.empty(shape, dtype=F64, pin_memory=True)

    def zeros(self) -> List:
        """Host arguments of zeros matching the stacked specs."""
        return _zeros(self.specs)

    def __call__(self, *host_args) -> List[np.ndarray]:
        mine = [_tree_map(lambda x: x[self.rank], a) for a in host_args]
        inner = self.inner
        if self.on_card:
            call = _current_dispatch()
            o = NULL_OBS if call is None else call.obs
            with inner._lock:
                events = inner.timing_events(call)
                inner._replay(mine, events)
                self._gather(self._d_all, inner._d_out, group=self.group)
                self._h_all.copy_(self._d_all, non_blocking=True)
                with o.device_wait("decide"):
                    torch.cuda.current_stream(inner.device).synchronize()
                inner.add_device_ms(call, events)
                out = self._h_all.numpy().reshape(
                    (self.n,) + tuple(inner._d_out.shape))
                return inner.split(out.swapaxes(0, 1))
        outs = inner(*mine)
        local = torch.from_numpy(np.stack([o.astype(np.float64)
                                           for o in outs]))
        everyone = torch.empty((self.n * local.shape[0],) + local.shape[1:],
                               dtype=F64)
        self._gather(everyone, local, group=self.group)
        out = everyone.numpy().reshape((self.n,) + tuple(local.shape))
        return [out[:, j].astype(o.dtype) for j, o in enumerate(outs)]


class ReplicaState:
    """Mutable serving state of one model replica.

    A plain ``AllocationService`` owns exactly one (its executable cache
    and decision counters); a ``ShardedAllocationService`` owns one per
    shard, so per-replica traffic stays observable after the fabric
    batches decisions across shards.

    The serving plane decides from worker threads, so the cache and
    counters are guarded by ``lock`` (``get_or_build`` is the one
    double-checked insert path), and compile classification is per-thread:
    a dispatch is a compile iff *its own* build inserted an executable or
    waited out a concurrent insert — not iff the global ``compiles``
    counter moved while it ran. AOT warmup (``repro_torch.serve.aot``)
    pins pre-built executables via ``install`` without touching
    ``compiles``, so a fully warmed replica serves with
    ``stats["compiles"] == 0``. On a card, the replica's CUDA graphs share
    one memory pool (``graph_pool``) and replay under ``replay_lock``.
    """

    __slots__ = ("shard", "stats", "compiled", "lock", "replay_lock",
                 "_pool", "_tls")

    def __init__(self, shard: int = 0):
        self.shard = int(shard)
        self.stats: Dict[str, int] = {"compiles": 0, "calls": 0,
                                      "queries": 0, "executables_retired": 0}
        self.compiled: Dict[Tuple, Callable] = {}
        self.lock = threading.RLock()
        self.replay_lock = threading.Lock()
        self._pool = None
        self._tls = threading.local()

    def graph_pool(self):
        """The memory pool every CUDA graph of this replica captures into
        (made on first use; a fresh one after ``invalidate``)."""
        with self.lock:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            return self._pool

    # ----------------------------------------- per-thread compile tracking --
    def begin_dispatch(self) -> None:
        self._tls.compile_stall = False

    def note_compile_stall(self) -> None:
        self._tls.compile_stall = True

    def compile_stalled(self) -> bool:
        return getattr(self._tls, "compile_stall", False)

    # --------------------------------------------------------- cache paths --
    def get_or_build(self, key: Tuple, build: Callable[[], Callable]):
        """Return the cached executable for ``key``, building it exactly
        once across threads. Every thread that raced the build — winner or
        loser — is flagged compile-stalled: its decide latency covered
        executable construction either way."""
        fn = self.compiled.get(key)
        if fn is not None:
            return fn
        with self.lock:
            fn = self.compiled.get(key)
            if fn is None:
                self.stats["compiles"] += 1
                fn = self.compiled[key] = build()
            self.note_compile_stall()
        return fn

    def install(self, key: Tuple, fn: Callable) -> bool:
        """Pin a pre-built executable (AOT warmup) without counting a
        compile. First install wins; returns whether ``fn`` was pinned."""
        with self.lock:
            if key in self.compiled:
                return False
            self.compiled[key] = fn
            return True

    def invalidate(self) -> int:
        """Retire every pinned/built executable (model hot-swap: the
        replaced replica must never dispatch a stale executable again).
        Dispatches already holding an executable reference finish on it;
        the next ``get_or_build`` rebuilds, into a fresh memory pool. The
        retired CUDA graphs and their buffers are freed once the last
        reference drops. Returns the number retired (also accumulated in
        ``stats["executables_retired"]``)."""
        with self.lock:
            n = len(self.compiled)
            self.compiled.clear()
            self._pool = None
            self.stats["executables_retired"] += n
            return n

    def count(self, calls: int = 0, queries: int = 0) -> None:
        """Thread-safe counter bump for the dispatch paths."""
        with self.lock:
            self.stats["calls"] += calls
            self.stats["queries"] += queries


# -------------------------------------------------------------- dispatch --
def _protocol_dispatch(engine, request: AllocationRequest,
                       ctx: DecisionContext, decide_params: Callable,
                       decide_fused: Callable) -> AllocationDecision:
    """The one ``decide()`` dispatch, shared by the single-replica service
    and the sharded fabric (which differ only in the stages passed in):
    validate the request (exactly one of ``model_in`` or ``(a, b)``),
    apply the observed-mode switch, and route (a, b) to the policy-only
    path, host models to host prediction + the device policy, device
    models to the fused stage — with the priced re-decide on the decoded
    parameters when the context carries prices."""
    B = request.batch_size()
    obs = request.observed_tokens if ctx.observed else None
    if request.a is not None or request.b is not None:
        if request.a is None or request.b is None:
            raise ValueError("AllocationRequest needs both a and b for the "
                             "policy-only path")
        if request.model_in:
            raise ValueError("ambiguous AllocationRequest: set model_in "
                             "or (a, b), not both")
        return decide_params(request.a, request.b, ctx.price, obs)
    if not request.model_in:
        raise ValueError("AllocationRequest needs model_in or (a, b)")
    if not engine.model.supports_fused:
        # host models (GBDT): host (a, b) prediction + device policy
        ref = (obs if obs is not None
               else np.full(B, engine.policy.max_tokens, np.int64))
        a, b = engine.model.predict_params_batch(request.model_in,
                                                 np.asarray(ref))
        return dataclasses.replace(
            decide_params(a, b, ctx.price, obs),
            provenance=np.full(B, Provenance.MODEL, np.int8))
    d = decide_fused(request.model_in, obs)
    if ctx.price is not None:
        # priced re-decide on the decoded parameters, as the reference
        d = dataclasses.replace(
            decide_params(d.a, d.b, ctx.price, obs),
            provenance=np.full(B, Provenance.MODEL, np.int8))
    return d


def _observed_dispatch(engine, span_name: str, request: AllocationRequest,
                       ctx: DecisionContext, decide_params: Callable,
                       decide_fused: Callable,
                       **span_attrs) -> AllocationDecision:
    """``_protocol_dispatch`` under the observability plane: one span per
    decide (with a built-vs-cached attribute), decision latency into the
    compile or steady-state histogram (per thread: only a call whose own
    build inserted, or waited out a concurrent insert of, an executable
    counts as a compile), the decide counters, and a sampled provenance
    row to the flight recorder."""
    o = engine.obs
    tr = o.tracer
    rep = engine.compile_state
    with tr.span(span_name, B=request.batch_size(),
                 path="history" if request.a is not None else "model",
                 priced=ctx.price is not None, **span_attrs) as sp:
        rep.begin_dispatch()
        call = _Dispatch(o)
        prev, _CURRENT.call = _current_dispatch(), call
        t0 = tr.clock()
        try:
            d = _protocol_dispatch(engine, request, ctx, decide_params,
                                   decide_fused)
        finally:
            _CURRENT.call = prev
        dt = tr.clock() - t0
        compiled = rep.compile_stalled()
        if sp is not None:
            sp.attrs["compiled"] = compiled
            if call.device_ms is not None:
                sp.attrs["device_ms"] = call.device_ms
    o.metrics.histogram(
        "decision_compile_s" if compiled else "decision_latency_s").record(dt)
    o.metrics.counter("decide_calls").inc()
    o.metrics.counter("decide_queries").inc(len(d))
    if o.recorder is not None:
        o.recorder.record(request, d, ctx)
    return d


def _count_model_work(o: Obs, model_in: Dict[str, np.ndarray],
                      rows: int) -> None:
    """The model-path counters of one stage call: ``model_in`` its real
    rows, ``rows`` the rows its executable computes (see the module
    docstring). Nothing is read where ``o``'s metrics do not record."""
    m = o.metrics
    if m is NULL_METRICS:
        return
    m.counter("model_rows").inc(len(next(iter(model_in.values()))))
    if "mask" not in model_in:
        return
    mask = np.asarray(model_in["mask"])
    n = np.count_nonzero(mask, axis=-1).astype(np.int64)
    m.counter("model_nodes").inc(int(n.sum()))
    m.counter("model_adj_entries").inc(int(np.sum(n * n)))
    m.counter("model_adj_slots").inc(int(rows) * int(mask.shape[-1]) ** 2)


def _shape_sig(model_in: Dict[str, np.ndarray]) -> Tuple:
    # full padded shapes (batch dim included): one cache entry == one
    # executable, so ``stats["compiles"]`` counts real builds
    return tuple(sorted((k, tuple(v.shape)) for k, v in model_in.items()))


class AllocationService:
    """Batched allocation decisions for one trained PCCModel."""

    # largest single batch; bigger requests are served in chunks
    MAX_BATCH = 4096

    def __init__(self, model, policy: Optional[AllocationPolicy] = None,
                 device: Union[str, torch.device, None] = None,
                 obs: Optional[Obs] = None, batch_floor: int = 8):
        self.device = resolve_device(device)
        if model.supports_fused and model.device != self.device:
            raise ValueError(f"model lives on {model.device}, service on "
                             f"{self.device}")
        self.model = model
        self.policy = AllocationPolicy() if policy is None else policy
        self.batch_floor = batch_floor
        self.replica = ReplicaState()
        self.obs = NULL_OBS if obs is None else obs

    @property
    def stats(self) -> Dict[str, int]:
        return self.replica.stats

    @property
    def compile_state(self) -> ReplicaState:
        return self.replica

    def replica_stats(self) -> List[Dict[str, int]]:
        """Decision counters of the one replica, as a one-shard list."""
        return [dict(self.replica.stats)]

    def _chunks(self, B: int) -> List[slice]:
        return [slice(i, min(i + self.MAX_BATCH, B))
                for i in range(0, B, self.MAX_BATCH)]

    # --------------------------------------------------------- executables --
    def _exe(self, stage: Callable, specs: Sequence[Spec]):
        return lambda: DecisionExecutable(stage, specs, self.device,
                                          self.replica)

    def _policy_cell(self, Bp: int, with_observed: bool):
        """(key, build) of the policy executable at bucket ``Bp``."""
        v = ((Bp,), F64)
        return (("policy", Bp, with_observed, self.policy),
                self._exe(make_policy_decide(self.policy, with_observed),
                          (v, v, ((Bp,), I64) if with_observed else None)))

    def _priced_cell(self, Bp: int, with_observed: bool):
        v = ((Bp,), F64)
        return (("priced", Bp, with_observed, self.policy),
                self._exe(make_priced_decide(self.policy, with_observed),
                          (v, v, v, ((Bp,), I64) if with_observed else None)))

    def _fused_cell(self, shapes: Dict[str, Tuple[int, ...]],
                    with_observed: bool):
        """(key, build) of the fused executable for padded input shapes
        ``shapes`` (batch dimension included)."""
        Bp = next(iter(shapes.values()))[0]
        sig = tuple(sorted((k, tuple(s)) for k, s in shapes.items()))
        return (("fused", self.model.cache_key, sig, with_observed,
                 self.policy),
                self._exe(make_fused_decide(self.model, self.policy,
                                            with_observed),
                          ({k: (tuple(s), F32) for k, s in shapes.items()},
                           ((Bp,), I64) if with_observed else None)))

    # ------------------------------------------------------------ protocol --
    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """A typed request + context in, a typed decision out:

          * ``request.a/b`` set      -> policy-only history path;
          * ``request.model_in`` set -> model path (host models predict
            (a, b) on the host and share the device policy);
          * ``context.price``        -> the priced policy twin;
          * ``context.observed``     -> honor ``request.observed_tokens``.

        ``stats["calls"]`` counts decision-stage invocations, not protocol
        entries: a priced model decision runs two stages (fused model +
        policy, then the priced policy twin on the decoded parameters) and
        accrues two calls.
        """
        ctx = DecisionContext() if context is None else context
        if ctx.shard_of is not None:
            raise ValueError(
                "AllocationService is single-replica; shard placement "
                "(DecisionContext.shard_of) needs a ShardedAllocationService "
                "or an Allocator")
        B = request.batch_size()
        if B > self.MAX_BATCH:
            return AllocationDecision.concat(
                self.decide(request.narrow(s), ctx.narrow(s))
                for s in self._chunks(B))
        return _observed_dispatch(self, "service.decide", request, ctx,
                                  self._decide_params, self._decide_fused)

    def _decide_params(self, a: np.ndarray, b: np.ndarray,
                       price: Optional[np.ndarray],
                       obs: Optional[np.ndarray]) -> AllocationDecision:
        a = np.asarray(a)
        B = a.shape[0]
        self.replica.count(calls=1, queries=B)
        Bp = batch_bucket(B, self.batch_floor)
        a64 = pad_to(np.asarray(a, np.float64), Bp)
        b64 = pad_to(np.asarray(b, np.float64), Bp)
        obs_p = None if obs is None else pad_to(np.asarray(obs, np.int64), Bp)
        if price is None:
            fn = self.replica.get_or_build(*self._policy_cell(
                Bp, obs is not None))
            toks, rt = fn(a64, b64, obs_p)
            price_out = np.ones(B, np.float64)
        else:
            p64 = np.ones(Bp, np.float64)      # neutral price on padded rows
            p64[:B] = np.asarray(price, np.float64)
            fn = self.replica.get_or_build(*self._priced_cell(
                Bp, obs is not None))
            toks, rt = fn(a64, b64, p64, obs_p)
            price_out = np.asarray(price, np.float64)
        toks, rt = toks[:B], rt[:B]
        return AllocationDecision(
            tokens=toks, runtime=rt, a=a, b=np.asarray(b),
            cost=toks.astype(np.float64) * rt, price=price_out,
            shard=np.zeros(B, np.int64),
            provenance=np.full(B, Provenance.HISTORY, np.int8))

    def _decide_fused(self, model_in: Dict[str, np.ndarray],
                      obs: Optional[np.ndarray]) -> AllocationDecision:
        B = next(iter(model_in.values())).shape[0]
        self.replica.count(calls=1, queries=B)
        Bp = batch_bucket(B, self.batch_floor)
        _count_model_work(self.obs, model_in, Bp)
        padded = {k: pad_to(np.asarray(v), Bp) for k, v in model_in.items()}
        # zero-padded observed rows are harmless: the bisection degenerates
        # and their outputs are sliced off below
        obs_p = None if obs is None else pad_to(np.asarray(obs, np.int64), Bp)
        fn = self.replica.get_or_build(*self._fused_cell(
            {k: v.shape for k, v in padded.items()}, obs is not None))
        toks, a, b, rt = fn(padded, obs_p)
        toks, rt = toks[:B], rt[:B]
        return AllocationDecision(
            tokens=toks, runtime=rt, a=a[:B], b=b[:B],
            cost=toks.astype(np.float64) * rt, price=np.ones(B, np.float64),
            shard=np.zeros(B, np.int64),
            provenance=np.full(B, Provenance.MODEL, np.int8))

    # ----------------------------------------------- legacy shims (one rel) --
    def allocate_batch(self, model_in: Dict[str, np.ndarray],
                       observed_tokens: Optional[np.ndarray] = None
                       ) -> AllocationResult:
        """Deprecated: use ``decide(AllocationRequest(model_in=...))``."""
        warn_deprecated("AllocationService.allocate_batch",
                        "decide(AllocationRequest(model_in=...))")
        return _as_result(self.decide(AllocationRequest(
            model_in=model_in, observed_tokens=observed_tokens)))

    def allocate_params(self, a: np.ndarray, b: np.ndarray,
                        observed_tokens: Optional[np.ndarray] = None
                        ) -> AllocationResult:
        """Deprecated: use ``decide(AllocationRequest(a=..., b=...))``."""
        warn_deprecated("AllocationService.allocate_params",
                        "decide(AllocationRequest(a=..., b=...))")
        return _as_result(self.decide(AllocationRequest(
            a=a, b=b, observed_tokens=observed_tokens)))

    def allocate_params_priced(self, a: np.ndarray, b: np.ndarray,
                               price: np.ndarray,
                               observed_tokens: Optional[np.ndarray] = None
                               ) -> AllocationResult:
        """Deprecated: use ``decide(AllocationRequest(a=..., b=...),
        DecisionContext(price=...))``."""
        warn_deprecated("AllocationService.allocate_params_priced",
                        "decide(..., DecisionContext(price=...))")
        return _as_result(self.decide(
            AllocationRequest(a=a, b=b, observed_tokens=observed_tokens),
            DecisionContext(price=price)))

    def allocate_dataset(self, ds, use_observed: bool = True
                         ) -> AllocationResult:
        """Deprecated: use ``decide(AllocationRequest.from_dataset(...))``."""
        warn_deprecated("AllocationService.allocate_dataset",
                        "decide(AllocationRequest.from_dataset(...))")
        return _as_result(self.decide(
            AllocationRequest.from_dataset(self.model, ds, use_observed)))


class ShardedAllocationService:
    """K replicas of one trained model behind a single batched API.

    Wraps an ``AllocationService`` (whose executable cache and counters
    keep serving single-shard traffic) and serves the same ``decide``
    protocol for shard-tagged traffic: ``DecisionContext.shard_of`` carries
    a shard rank in [0, K) per row (None places everything on shard 0);
    rows are stacked into a (K, Bp) block and one executable decides every
    replica's rows (see the module docstring for why that is the per-shard
    math); results come back in input order.

    With ``mesh``, a ``("shard",)`` ``DeviceMesh`` of exactly ``n_shards``
    ranks (``launch.mesh.make_allocation_mesh``), each rank decides its own
    shard through the single-shard executable and the ranks' outputs are
    gathered (``MeshExecutable``), as the reference runs its per-shard stage
    under ``shard_map`` on one device per shard. A mesh of another size, or
    one shard, is not used (``self.mesh`` is then None) and the block is
    decided on the service's device, as the reference falls back to
    ``vmap``. Either way every rank reads the same decisions.

    Fabric-level counters accrue into the wrapped service's ``stats`` (one
    executable cache and one lock for fabric + service); per-replica
    traffic lands in ``replicas[k].stats``. Both are counted on the host
    from ``shard_of``, so every rank of a mesh reads the same counters as
    the one-device fabric.
    """

    def __init__(self, service: AllocationService, n_shards: int = 1,
                 mesh=None):
        assert n_shards >= 1
        self.service = service
        self.model = service.model
        self.policy = service.policy
        self.n_shards = int(n_shards)
        self.replicas = [ReplicaState(k) for k in range(n_shards)]
        # one rank a shard: any other mesh (and one shard) means the
        # block is decided on this rank's device
        self.mesh = (mesh if mesh is not None and n_shards > 1
                     and mesh.mesh_dim_names == ("shard",)
                     and mesh.size() == n_shards else None)

    @property
    def stats(self) -> Dict[str, int]:
        return self.service.stats

    @property
    def compile_state(self) -> ReplicaState:
        return self.service.replica

    @property
    def obs(self) -> Obs:
        # one Obs bundle per service; the fabric shares its wrapped
        # service's so single-shard and fabric traffic land in one place
        return self.service.obs

    @obs.setter
    def obs(self, value: Obs) -> None:
        self.service.obs = value

    def replica_stats(self) -> List[Dict[str, int]]:
        """Per-shard decision counters, shard-rank order."""
        return [dict(r.stats) for r in self.replicas]

    # --------------------------------------------------------- executables --
    def _sharded_cell(self, key: Tuple, per_shard: Callable,
                      specs: Sequence[Spec]):
        """(key, build) of a (K, Bp, ...) executable over ``per_shard``, the
        single-shard stage: on the mesh, this rank's shard through the
        stage at (Bp, ...) plus the gather; else the stage over the
        flattened block."""
        if self.mesh is None:
            return key + (False,), self.service._exe(_over_shards(per_shard),
                                                     specs)
        mesh = self.mesh
        return key + (True,), lambda: MeshExecutable(
            self.service._exe(per_shard, [_one_shard(sp) for sp in specs])(),
            specs, mesh)

    def _sharded_policy_cell(self, Bp: int, with_observed: bool,
                             priced: bool):
        """(key, build) of the (K, Bp) policy executable."""
        K = self.n_shards
        v = ((K, Bp), F64)
        return self._sharded_cell(
            ("sharded_policy", K, Bp, with_observed, priced, self.policy),
            make_sharded_policy_per_shard(self.policy, with_observed, priced),
            (v, v, v, ((K, Bp), I64)))

    def _sharded_fused_cell(self, shapes: Dict[str, Tuple[int, ...]],
                            with_observed: bool):
        """(key, build) of the fused executable for stacked (K, Bp, ...)
        input shapes ``shapes``."""
        K, Bp = next(iter(shapes.values()))[:2]
        sig = tuple(sorted((k, tuple(s)) for k, s in shapes.items()))
        return self._sharded_cell(
            ("sharded_fused", K, self.model.cache_key, sig, with_observed,
             self.policy),
            make_sharded_fused_per_shard(self.model, self.policy,
                                         with_observed),
            ({k: (tuple(s), F32) for k, s in shapes.items()},
             ((K, Bp), I64)))

    # ------------------------------------------------------------ stacking --
    def _place(self, shard_of: np.ndarray):
        shard_of = np.asarray(shard_of, np.int64)
        if shard_of.size and (shard_of.min() < 0
                              or shard_of.max() >= self.n_shards):
            raise ValueError(f"shard_of outside [0, {self.n_shards})")
        pos, counts, Bp = shard_positions(shard_of, self.n_shards,
                                          self.service.batch_floor)
        for k, r in enumerate(self.replicas):
            if counts[k]:
                r.count(calls=1, queries=int(counts[k]))
        self.service.replica.count(calls=1, queries=int(shard_of.size))
        return shard_of, pos, Bp

    def _stack(self, shard_of, pos, Bp, x, dtype, fill=0) -> np.ndarray:
        """Scatter a flat (B, ...) array into its (K, Bp, ...) block."""
        x = np.asarray(x, dtype)
        out = np.full((self.n_shards, Bp) + x.shape[1:], fill, dtype)
        out[shard_of, pos] = x
        return out

    # ------------------------------------------------------------ protocol --
    def decide(self, request: AllocationRequest,
               context: Optional[DecisionContext] = None
               ) -> AllocationDecision:
        """The fabric's ``decide``: the single-shard protocol, with
        ``context.shard_of`` placing each row on a replica."""
        ctx = DecisionContext() if context is None else context
        B = request.batch_size()
        if ctx.shard_of is None:
            ctx = dataclasses.replace(ctx, shard_of=np.zeros(B, np.int64))
        if B > self.service.MAX_BATCH:
            return AllocationDecision.concat(
                self.decide(request.narrow(s), ctx.narrow(s))
                for s in self.service._chunks(B))
        shard_of = ctx.shard_of
        return _observed_dispatch(
            self, "fabric.decide", request, ctx,
            lambda a, b, price, obs: self._decide_params(shard_of, a, b,
                                                         price, obs),
            lambda model_in, obs: self._decide_fused(shard_of, model_in,
                                                     obs),
            K=self.n_shards)

    def _decide_params(self, shard_of, a, b, price, obs
                       ) -> AllocationDecision:
        a = np.asarray(a)
        B = a.shape[0]
        shard_of, pos, Bp = self._place(shard_of)
        a2 = self._stack(shard_of, pos, Bp, a, np.float64)
        b2 = self._stack(shard_of, pos, Bp, b, np.float64)
        p2 = (np.ones((self.n_shards, Bp), np.float64) if price is None
              else self._stack(shard_of, pos, Bp, price, np.float64, fill=1))
        obs2 = (np.zeros((self.n_shards, Bp), np.int64) if obs is None
                else self._stack(shard_of, pos, Bp, obs, np.int64))
        fn = self.service.replica.get_or_build(*self._sharded_policy_cell(
            Bp, obs is not None, price is not None))
        toks, rt = fn(a2, b2, p2, obs2)
        toks, rt = toks[shard_of, pos], rt[shard_of, pos]
        return AllocationDecision(
            tokens=toks, runtime=rt, a=a, b=np.asarray(b),
            cost=toks.astype(np.float64) * rt,
            price=(np.ones(B, np.float64) if price is None
                   else np.asarray(price, np.float64)),
            shard=shard_of,
            provenance=np.full(B, Provenance.HISTORY, np.int8))

    def _decide_fused(self, shard_of, model_in, obs) -> AllocationDecision:
        """Stack each replica's inputs, run features -> decode -> policy
        for all K replicas in one executable call, unstack to input
        order."""
        B = next(iter(model_in.values())).shape[0]
        shard_of, pos, Bp = self._place(shard_of)
        _count_model_work(self.obs, model_in, self.n_shards * Bp)
        stacked = {k: self._stack(shard_of, pos, Bp, v, np.asarray(v).dtype)
                   for k, v in model_in.items()}
        obs2 = (np.zeros((self.n_shards, Bp), np.int64) if obs is None
                else self._stack(shard_of, pos, Bp, obs, np.int64))
        fn = self.service.replica.get_or_build(*self._sharded_fused_cell(
            {k: v.shape for k, v in stacked.items()}, obs is not None))
        toks, a, b, rt = fn(stacked, obs2)
        toks, rt = toks[shard_of, pos], rt[shard_of, pos]
        return AllocationDecision(
            tokens=toks, runtime=rt, a=a[shard_of, pos], b=b[shard_of, pos],
            cost=toks.astype(np.float64) * rt,
            price=np.ones(B, np.float64), shard=shard_of,
            provenance=np.full(B, Provenance.MODEL, np.int8))

    # ----------------------------------------------- legacy shims (one rel) --
    def allocate_params(self, shard_of: np.ndarray, a: np.ndarray,
                        b: np.ndarray,
                        observed_tokens: Optional[np.ndarray] = None,
                        price: Optional[np.ndarray] = None
                        ) -> AllocationResult:
        """Deprecated: use ``decide(AllocationRequest(a=..., b=...),
        DecisionContext(shard_of=...))``."""
        warn_deprecated("ShardedAllocationService.allocate_params",
                        "decide(..., DecisionContext(shard_of=...))")
        return _as_result(self.decide(
            AllocationRequest(a=a, b=b, observed_tokens=observed_tokens),
            DecisionContext(price=price, shard_of=shard_of)))

    def allocate_params_priced(self, shard_of: np.ndarray, a: np.ndarray,
                               b: np.ndarray, price: np.ndarray,
                               observed_tokens: Optional[np.ndarray] = None
                               ) -> AllocationResult:
        """Deprecated: use ``decide(...,
        DecisionContext(price=..., shard_of=...))``."""
        warn_deprecated("ShardedAllocationService.allocate_params_priced",
                        "decide(..., DecisionContext(price=..., "
                        "shard_of=...))")
        return _as_result(self.decide(
            AllocationRequest(a=a, b=b, observed_tokens=observed_tokens),
            DecisionContext(price=np.asarray(price, np.float64),
                            shard_of=shard_of)))

    def allocate_batch(self, shard_of: np.ndarray,
                       model_in: Dict[str, np.ndarray],
                       observed_tokens: Optional[np.ndarray] = None
                       ) -> AllocationResult:
        """Deprecated: use ``decide(AllocationRequest(model_in=...),
        DecisionContext(shard_of=...))``."""
        warn_deprecated("ShardedAllocationService.allocate_batch",
                        "decide(..., DecisionContext(shard_of=...))")
        return _as_result(self.decide(
            AllocationRequest(model_in=model_in,
                              observed_tokens=observed_tokens),
            DecisionContext(shard_of=shard_of)))
