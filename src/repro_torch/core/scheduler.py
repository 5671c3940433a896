"""Batched continuous-batching serving scheduler (survey §2.3 at throughput),
the PyTorch twin of the JAX package's ``core/scheduler.py``.

  * SLOTS — ``batch_size`` slots, each holding one in-flight request; the
    per-slot device state lives behind the ``SequenceState`` adapters of
    ``core/seq_state.py`` (paged block pool by default, dense slabs as the
    parity oracle, whole per-slot states for the recurrent families).  The
    scheduler calls ``admit / flush / prepare_tick / retire`` and never
    branches on layout or family itself.
  * PREFILL on admission is pow2 LENGTH-BUCKETED and, past
    ``prefill_chunk`` entries, CHUNKED one chunk per tick into a detached
    cache that lands through ``SequenceState.finalize``.
  * OPEN-LOOP TRAFFIC + LATENCY (``core/traffic.py``): ``submit(at=...)``
    arrival times against a virtual (default) or wall clock; per-request
    lifecycle events roll up into p50/p99 TTFT/TPOT and SLO goodput.
  * DECODE — one ``Lane.chunk`` of up to ``tick_tokens`` steps over the
    whole batch per tick, uncertainty accumulated on the device, and ONE
    batched host pull per tick.  The host mirrors of the slots' pending
    token, budget and uncertainty are exact between ticks and are uploaded
    at the start of each.
  * POLICY — every collaboration decision flows through the
    ``CollabPolicy`` hooks (``core/policy.py``): ``assign`` at admission,
    a vectorized ``decide`` per retirement wave, ``feedback`` per
    completion.
  * RETIRE / ADMIT / COALESCE each tick, with semantic-cache hits and
    identical in-flight prompts served without a slot, and
    PREEMPTION-BY-SWAP when the paged pool cannot back a waiting request
    (strict arrival order; the victim is the slot holding its reservation
    longest per block of KV it would checkpoint).
  * ESCALATION runs GROUPED: one batched cloud generation ("cloud"), one
    batched skeleton + edge completion ("skeleton"), or one
    ``BatchedSpecDecoder`` group ("speculative") on the linear, tree or
    self lane, each padded to ``batch_size``.  Tree and self groups run on
    dense side states (``Lane.dense_side``), whatever the serving layout.

  * ADAPTATION (``adaptation=``, a ``core/adaptation.py::AdaptationLoop``):
    every completion retires into its feedback store from ``_finish``; the
    cloud passes emit top-k teacher logits when it asks for them, pulled
    with the token tape; between ticks the loop may train and hand back
    new edge weights, which the drain rebinds (``SequenceState.rebind``).
    With ``adaptation=None`` serving is unchanged to the token.

  * MESH (``mesh=``, a ``launch/mesh.Mesh``; one process per mesh
    position, every rank running this same scheduler): edge drafts are
    DATA-parallel (the slots split over the data axes, params
    replicated), the cloud verifier TENSOR-parallel over 'model' (params
    placed by ``launch/sharding.py``).  Every host pull returns the whole
    batch on every rank, so every rank makes the same decisions.  Every
    lane (linear, tree, self) and every layout (paged, dense, recurrent)
    is served there, each state a rank's local view
    (``core/seq_state.py``), with a dense, moe (experts over 'model') or
    vlm cloud whatever its head counts (``launch/sharding.py``).  An
    adaptation loop trains on the whole edge params on every rank (the
    same store from the same pulls, the same seed), every rank swaps in
    rank 0's result, and each rank serves its view of it.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.analysis import hot_path
from repro_torch.core.cache import SemanticCache, embed_tokens_mean
from repro_torch.core.policy import (ACTIONS, LANES, cloud_tokens,
                                     resolve_policy, trace_quality)
from repro_torch.core.seq_state import (Lane, host_pull, layout_for,
                                        pow2_steps, resolve_kv_layout)
from repro_torch.core.speculative import BatchedSpecDecoder
from repro_torch.core.tree_speculation import branching_for
from repro_torch.core.traffic import VirtualClock, latency_rollup
from repro_torch.models.model import require_token_prompts


@dataclasses.dataclass
class RequestTrace:
    path: str                       # cache | edge | speculative | cloud | skeleton
    edge_calls: int = 0
    cloud_passes: int = 0
    uncertainty: float = 0.0
    tokens: Optional[List[int]] = None
    # cloud top-k teacher logits for the emitted tokens, when the wave's
    # cloud pass already paid for them: (values, indices) arrays of shape
    # (len(tokens), k) — serve-time distillation supervision
    teacher_topk: Optional[Tuple[np.ndarray, np.ndarray]] = None


# ---------------------------------------------------------------- requests
@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    key: Optional[np.ndarray] = None    # semantic-cache key (set at admit)
    lane: Optional[str] = None          # policy.assign outcome (once per req)
    at: Optional[float] = None          # arrival time, clock ms (None = now)
    spent: int = 0                      # edge decode steps actually consumed
    domain: Optional[int] = None        # workload tag
    draft: Optional[List[int]] = None   # discarded edge draft (escalations)


@dataclasses.dataclass
class _Slot:
    req: Optional[_Request] = None
    tokens: List[int] = dataclasses.field(default_factory=list)


class BatchedEngine:
    """Slot-based collaborative serving engine (see module docstring).

    Collaboration decisions are delegated to ``policy`` (a
    ``core/policy.py::CollabPolicy``); the default
    ``SpeculativePolicy(threshold=0.6)`` escalates uncertain edge output
    into grouped speculative verification.

    Serving knobs: ``clock`` (default ``VirtualClock()``), ``slo_ms``,
    ``prefill_chunk`` (entries above which admission prefills chunked;
    None = ``tick_tokens``, 0 = always whole-prompt), ``stop_token``.
    KV knobs: ``kv_layout`` ("auto" -> paged, "paged", "dense"),
    ``kv_block_size``, ``kv_blocks`` (total pool blocks incl. the trap).
    ``attn_backend``: "auto" runs the Hopper kernels (paged and dense
    decode, flash prefill, spec verify, tree verify) on CUDA and their
    plain versions on the CPU; "plain" forces the plain versions everywhere
    (the parity oracle).  The device is the one the parameters passed to
    ``run`` live on.  ``graphs``: on CUDA the edge and cloud decode ticks
    (``Lane.chunk``, every layout) and the speculative round (linear, tree
    and self lanes, KV and recurrent states) run as CUDA graphs, captured
    once per shape and buffer set (``core/capture.py``, the twin of the
    JAX package's ``jax.jit``), and so do the KV lanes' admission
    prefills and chunked-prefill extends (``Lane.prefill``, per ``max_seq``
    and token bucket; a recurrent lane prefills eager at exact length);
    ``graphs=False`` runs them eager, the same work launch by launch.
    ``stats()`` reports each lane's ``captures`` and the ``graphs`` rules
    (a mesh runs eager by rule).  Drains and escalation groups reuse the
    device buffers of earlier states of the same shape (``Lane.make_state``,
    ``Lane.release``; a recurrent step writes its state back into them),
    so a steady state captures nothing; a lane keeps a bounded number of
    released states and each captured function a bounded number of graphs
    (``seq_state.MAX_SPARE_STATES``, ``capture.MAX_GRAPHS``).

    Speculation lane: ``spec_mode`` ("linear" | "tree" | "self"; default
    the policy's ``spec_mode``, else linear), ``spec_tree_width`` (the
    tree's first-level branches, default 2) and ``spec_exit_layer`` (the
    self lane's draft depth, default half the edge model).  A lane the
    model families cannot serve falls back to linear; ``stats()`` reports
    the effective one.
    """

    def __init__(self, edge_model, cloud_model, *, batch_size: int = 8,
                 gamma: int = 4, temperature: float = 0.0,
                 escalate_threshold: Optional[float] = None,
                 estimator: str = "entropy",
                 escalation: Optional[str] = None, policy=None,
                 use_cache: bool = True,
                 cache_threshold: float = 0.95, skeleton_len: int = 8,
                 tick_tokens: int = 16, seed: int = 0,
                 kv_layout: str = "auto", kv_block_size: int = 32,
                 kv_blocks: Optional[int] = None, clock=None,
                 slo_ms: Optional[float] = None,
                 prefill_chunk: Optional[int] = None,
                 stop_token: Optional[int] = None,
                 spec_mode: Optional[str] = None,
                 spec_tree_width: Optional[int] = None,
                 spec_exit_layer: Optional[int] = None,
                 attn_backend: str = "auto",
                 mesh=None, adaptation=None, graphs: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if tick_tokens < 1:
            raise ValueError(f"tick_tokens must be >= 1, got {tick_tokens}")
        if kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got "
                             f"{kv_block_size}")
        if prefill_chunk is not None and prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0 (0 = whole-prompt "
                             f"prefill), got {prefill_chunk}")
        for m in (edge_model, cloud_model):
            require_token_prompts(m.cfg, "BatchedEngine")
        self.policy = resolve_policy(policy, escalation, escalate_threshold)
        self.kv_layout = resolve_kv_layout(edge_model, cloud_model, kv_layout)
        self.kv_block_size = kv_block_size
        self.kv_blocks = kv_blocks
        self.edge_model = edge_model
        self.cloud_model = cloud_model
        self.batch_size = batch_size
        self.gamma = gamma
        self.temperature = temperature
        self.skeleton_len = skeleton_len
        self.tick_tokens = tick_tokens
        self.seed = seed
        self.clock = clock if clock is not None else VirtualClock()
        self.slo_ms = slo_ms
        self.stop_token = stop_token
        self.prefill_chunk = tick_tokens if prefill_chunk is None \
            else prefill_chunk
        self._esc_fns = {"cloud": self._cloud_escalate,
                         "skeleton": self._skeleton_escalate,
                         "speculative": self._spec_escalate}
        # mesh serving: edge drafts are DATA-parallel (batch slots split
        # over the data axes, params replicated); the cloud verifier is
        # TENSOR-parallel over 'model'.  Escalation groups are whole on
        # every data rank (gather_wave hands each the full wave), so the
        # cloud lane never data-splits its pools
        self.mesh = mesh
        self._data_shards = 1
        if mesh is not None:
            dp = 1
            for a in mesh.axis_names:
                if a != "model":
                    dp *= mesh.shape[a]
            self._data_shards = dp if batch_size % dp == 0 else 1
        self.edge = Lane(edge_model, estimator, temperature,
                         layout=layout_for(edge_model, self.kv_layout),
                         block_size=kv_block_size, attn_backend=attn_backend,
                         mesh=mesh, data_shards=self._data_shards,
                         graphs=graphs)
        self.cloud = Lane(cloud_model, estimator, temperature,
                          layout=layout_for(cloud_model, self.kv_layout),
                          block_size=kv_block_size,
                          attn_backend=attn_backend, mesh=mesh, graphs=graphs)
        self.cache = SemanticCache(threshold=cache_threshold) if use_cache \
            else None
        # online adaptation (AdaptationLoop or None): completions feed its
        # store from _finish, and the drain offers it a hot-swap point
        # between ticks
        self.adaptation = adaptation
        if adaptation is not None:
            adaptation.bind(edge_model, mesh)
        # speculation lane: engine kwarg > policy attribute > linear.  A
        # model family the requested lane cannot serve falls back to the
        # linear tape; stats()["spec_mode"] reports the effective mode
        mode = spec_mode if spec_mode is not None \
            else getattr(self.policy, "spec_mode", None) or "linear"
        if mode not in ("linear", "tree", "self"):
            raise ValueError(f"unknown spec_mode {mode!r}; "
                             "known: linear | tree | self")
        width = spec_tree_width if spec_tree_width is not None \
            else getattr(self.policy, "spec_tree_width", None) or 2
        exit_layer = spec_exit_layer if spec_exit_layer is not None \
            else getattr(self.policy, "spec_exit_layer", None)
        if mode == "tree" and not BatchedSpecDecoder.tree_supported(
                edge_model, cloud_model):
            mode = "linear"
        if mode == "self" and not BatchedSpecDecoder.self_supported(
                edge_model):
            mode = "linear"
        self.spec_mode = mode
        if mode == "tree":
            self.spec = BatchedSpecDecoder(
                edge_model, cloud_model, gamma=gamma,
                temperature=temperature, mode="tree",
                branching=branching_for(width, gamma),
                attn_backend=attn_backend, graphs=graphs)
        elif mode == "self":
            self.spec = BatchedSpecDecoder(
                edge_model, edge_model, gamma=gamma,
                temperature=temperature, mode="self",
                exit_layer=exit_layer, attn_backend=attn_backend,
                graphs=graphs)
        else:
            self.spec = BatchedSpecDecoder(edge_model, cloud_model,
                                           gamma=gamma,
                                           temperature=temperature,
                                           kv_layout=self.kv_layout,
                                           attn_backend=attn_backend,
                                           graphs=graphs)
        # tree/self groups always run dense per-slot caches (block-masked
        # extends are a dense-layout feature); Lane.dense_side() owns that
        # layout decision and is identity on lanes that are already dense.
        # Linear groups keep using the serving lanes
        self._spec_edge = self.edge if mode == "linear" \
            else self.edge.dense_side()
        self._spec_cloud = self.cloud.dense_side() if mode == "tree" \
            else self.cloud
        self._queue: collections.deque = collections.deque()
        self._next_rid = 0
        # intra-batch dedup: in-flight leaders and their coalesced followers
        self._leaders: List[Tuple[np.ndarray, int]] = []
        self._followers: Dict[int, List[_Request]] = {}
        self._kv_stats: Dict[str, Any] = {}
        self._swapped: Dict[int, dict] = {}
        self._preempts = 0
        self._prefill_jobs: Dict[int, dict] = {}    # slot -> chunked job
        self._events: Dict[int, dict] = {}          # rid -> lifecycle stamps
        # ONE generator per engine, reseeded every drain: the captured tick
        # and round are registered with it (core/capture.py)
        self._gen: Optional[torch.Generator] = None
        # off-mesh with an adaptation loop: the edge parameters served, a
        # private copy each swap lands in IN PLACE (the graphs read them
        # where they lie)
        self._served = None
        self._dev = None

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new: int, at: Optional[float] = None,
               domain: Optional[int] = None) -> int:
        """Queue a request.  ``at`` is an OPEN-LOOP arrival time in clock
        milliseconds (None = already arrived)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 2:
            raise ValueError("the scheduler needs >= 2 prompt tokens")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, prompt, max_new, at=at,
                                    domain=domain))
        return rid

    def _note_group(self, *states):
        live = sum(s.peak_bytes for s in states)
        self._kv_stats["kv_group_peak_bytes"] = max(
            self._kv_stats.get("kv_group_peak_bytes", 0), live)

    # ------------------------------------------------------------ dedup
    def _match_leader(self, key: np.ndarray) -> Optional[int]:
        """rid of an in-flight request whose cache key matches ``key`` at
        the semantic-cache threshold (cosine), else None."""
        if not self._leaders:
            return None
        u = SemanticCache._norm(key)
        for lk, rid in self._leaders:
            if float(u @ lk) >= self.cache.threshold:
                return rid
        return None

    # ------------------------------------------------------------ run
    def run(self, edge_params, cloud_params) -> Dict[int, RequestTrace]:
        """Drain the queue; returns {rid: RequestTrace} for this drain.

        With ``mesh=...`` the drain runs inside a ``runtime.mesh_context``:
        the edge params stay replicated (every rank holds them whole; when
        its kv-heads split over 'model' each rank attends its own heads,
        ``sharding.local_attention``), the cloud params are cut to this
        rank's blocks per ``launch/sharding.py`` unless the caller placed
        them already (``sharding.init_placed``), and the stats gain
        ``mesh_devices`` and ``mesh_shape``.  An adaptation loop trains on
        the whole edge params, and each swap is served through the same
        view.  ``mesh=None`` takes the exact pre-mesh path."""
        if self.mesh is None:
            return self._run_impl(edge_params, cloud_params)
        from repro_torch.launch.sharding import local_attention, place_params
        cloud_params = place_params(cloud_params, self.mesh,
                                    self.cloud_model.cfg)
        with runtime.mesh_context(self.mesh):
            res = self._run_impl(
                edge_params, cloud_params,
                lambda p: local_attention(p, self.mesh, self.edge_model.cfg))
        self._kv_stats["mesh_devices"] = self.mesh.size
        self._kv_stats["mesh_shape"] = {k: int(v)
                                        for k, v in self.mesh.shape.items()}
        return res

    @hot_path
    def _run_impl(self, edge_params, cloud_params,
                  edge_view=None) -> Dict[int, RequestTrace]:
        """The drain; ``edge_view(params)`` is what the edge serves with
        of its whole params (a rank's view on a mesh), which is what the
        adaptation loop trains and swaps."""
        if not self._queue:
            return {}
        view = edge_view or (lambda p: p)
        # adaptation persists ACROSS drains: start from the last hot-swapped
        # edge weights, not the caller's baseline
        edge_whole = edge_params if self.adaptation is None \
            else self.adaptation.current(edge_params)
        edge_params = self._serve_edge(edge_whole) if self._swaps_in_place \
            else view(edge_whole)
        clock = self.clock
        t0 = clock.now()
        for r in self._queue:
            if r.at is None:
                r.at = t0
        # strict ARRIVAL order (ties by rid)
        self._queue = collections.deque(
            sorted(self._queue, key=lambda r: (r.at, r.rid)))
        B = self.batch_size
        dev = edge_params.embed.device
        if self._gen is None or self._gen.device != dev:
            self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.seed)
        self._dev = dev
        # slot capacity: prompt + generation + speculative overdraft margin
        # (a tree lane overdrafts a full padded tree per round)
        ovr = self.spec.plan.n_pad if self.spec_mode == "tree" else self.gamma
        self._slot_len = max(r.prompt.size + r.max_new for r in self._queue) \
            + 2 * max(ovr, 16) + 8
        self._kv_stats = {"kv_layout": self.kv_layout, "ticks": 0,
                          "tick_seconds": 0.0}
        state = self.edge.make_state(edge_params, B, self._slot_len,
                                     num_blocks=self.kv_blocks)
        # host mirrors of each slot's pending token, budget and summed
        # uncertainty: every update is either host-originated (admit,
        # finalize, swap) or comes off the ONE batched pull after a tick
        tok_h = np.zeros((B,), np.int32)
        steps_h = np.zeros((B,), np.int32)
        unc_h = np.zeros((B,), np.float32)
        slots = [_Slot() for _ in range(B)]
        results: Dict[int, RequestTrace] = {}
        self._leaders, self._followers = [], {}
        self._swapped = {}                      # rid -> host swap handle
        self._preempts = 0
        self._prefill_jobs = {}                 # slot -> detached chunk job
        self._events = {r.rid: {"submit_ms": float(r.at),
                                "swaps": 0, "defers": 0}
                        for r in self._queue}
        stop = torch.full((), -1 if self.stop_token is None
                          else int(self.stop_token), dtype=torch.int32,
                          device=dev)

        while self._queue or self._swapped or any(s.req is not None
                                                  for s in slots):
            # ---- online-adaptation hot-swap point, BETWEEN ticks: the new
            # edge weights have the serving tree's structure, shapes and
            # dtypes, so the in-flight caches stay valid; the work queued
            # before the swap reads the old tensors
            if self.adaptation is not None:
                swapped_p = self.adaptation.maybe_update(edge_whole)
                if swapped_p is not None:
                    edge_whole = swapped_p
                    if self._swaps_in_place:
                        self._serve_edge(edge_whole)    # lands in place
                    else:
                        edge_params = view(edge_whole)
                        state.rebind(edge_params)
            free = [b for b in range(B) if slots[b].req is None]
            wave: set = set()       # slots admitted/resumed this wave
            stalled = False
            # ---- resume swapped-out victims first (they predate the queue)
            while self._swapped and free:
                rid0 = min(self._swapped)
                b = free[0]
                if not state.swap_in(b, self._swapped[rid0]["kv"]):
                    stalled = True  # pool still tight; retry next tick
                    break
                h = self._swapped.pop(rid0)
                free.pop(0)
                wave.add(b)
                slots[b] = h["slot"]
                tok_h[b], steps_h[b], unc_h[b] = \
                    h["tok"], h["steps"], h["unc"]
            # ---- admission probe over every ARRIVED request in a bounded
            # window; cache hits, coalesced followers and cloud-lane
            # requests never occupy a slot.  A stalled swap-in blocks new
            # admissions (strict arrival order).
            deferred = False
            cloud_wave: List[_Request] = []
            now = clock.now()
            if self._queue and not stalled:
                cands: List[_Request] = []
                while self._queue and len(cands) < len(free) + B \
                        and self._queue[0].at <= now:
                    cands.append(self._queue.popleft())
                hits: List[Optional[Any]] = [None] * len(cands)
                if self.cache is not None and cands:
                    for r in cands:
                        if r.key is None:
                            r.key = embed_tokens_mean(self.edge_model,
                                                      edge_params, r.prompt)
                    hits = self.cache.lookup_batch(
                        np.stack([r.key for r in cands]))
                putback: List[_Request] = []
                pend_keys: List[np.ndarray] = []
                share = state.share_hints([r.prompt for r in cands])

                def stay(r):
                    # r stays queued; matching requests probed later this
                    # wave must stay BEHIND it (pend_keys)
                    putback.append(r)
                    if r.key is not None:
                        pend_keys.append(SemanticCache._norm(r.key))

                for r, hit, sharable in zip(cands, hits, share):
                    if deferred:
                        putback.append(r)   # pool pressure aborts the wave
                        continue
                    if pend_keys and r.key is not None and any(
                            float(SemanticCache._norm(r.key) @ k)
                            >= self.cache.threshold for k in pend_keys):
                        stay(r)
                        continue
                    if hit is not None:
                        ev = self._events[r.rid]
                        ev["first_token_ms"] = ev["retire_ms"] = now
                        ev["path"], ev["tokens"] = "cache", len(hit)
                        results[r.rid] = RequestTrace("cache",
                                                      tokens=list(hit))
                        continue
                    if self.cache is not None:
                        # coalesce with an identical in-flight request
                        lid = self._match_leader(r.key)
                        if lid is not None:
                            self._followers.setdefault(lid, []).append(r)
                            self.cache.hits += 1
                            continue
                    # task assignment, ONCE per request
                    if r.lane is None:
                        r.lane = self.policy.assign({
                            "rid": r.rid, "prompt": r.prompt,
                            "prompt_len": int(r.prompt.size),
                            "max_new": int(r.max_new),
                            "queue_depth": len(self._queue),
                            "free_slots": len(free),
                            "inflight": sum(s.req is not None
                                            for s in slots),
                            "at_ms": float(r.at), "now_ms": now,
                            "wait_ms": now - float(r.at),
                            "slo_ms": self.slo_ms})
                        if r.lane not in LANES:
                            raise ValueError(
                                f"policy {self.policy.name!r} assigned "
                                f"unknown lane {r.lane!r}; known: "
                                f"{' | '.join(LANES)}")
                    if r.lane == "cloud":
                        # cloud-only: one grouped batched cloud generation
                        if len(cloud_wave) < B:
                            if self.cache is not None:
                                self._leaders.append(
                                    (SemanticCache._norm(r.key), r.rid))
                            cloud_wave.append(r)
                        else:
                            stay(r)
                        continue
                    if not free:
                        stay(r)             # collab/edge: needs a slot
                        continue
                    b = free.pop(0)
                    need = r.prompt.size - 1 + r.max_new
                    chunked = (0 < self.prefill_chunk < r.prompt.size - 1
                               and not sharable)
                    admit = state.begin if chunked else state.admit
                    ok = admit(b, r.prompt, need)
                    if not ok and not state.fits_empty(need):
                        # private footprint exceeds the whole pool: defer,
                        # and fail fast once even live sharing cannot cover
                        if not state.fits_empty(need, r.prompt):
                            raise RuntimeError(
                                f"request {r.rid} needs more KV blocks "
                                "than the whole pool; raise kv_blocks")
                    else:
                        while not ok:
                            # pool full: preempt-by-swap, retry until
                            # admitted or out of victims
                            v = self._pick_victim(state, slots, steps_h,
                                                  wave)
                            if v is None:
                                break
                            vreq = slots[v].req
                            self._swapped[vreq.rid] = {
                                "kv": state.swap_out(v),
                                "slot": slots[v],
                                "tok": int(tok_h[v]),
                                "steps": int(steps_h[v]),
                                "unc": float(unc_h[v]),
                            }
                            self._events[vreq.rid]["swaps"] += 1
                            slots[v] = _Slot()
                            steps_h[v] = 0
                            free.append(v)
                            self._preempts += 1
                            ok = admit(b, r.prompt, need)
                    if not ok:
                        # defer this and the rest, keeping arrival order
                        free.insert(0, b)
                        self._events[r.rid]["defers"] += 1
                        putback.append(r)
                        deferred = True
                        continue
                    slots[b] = _Slot(req=r)
                    wave.add(b)
                    self._events[r.rid]["admit_ms"] = now
                    if chunked:
                        self._prefill_jobs[b] = self.edge.start_prefill(
                            edge_params, r.prompt,
                            state.detached_len(r.prompt.size - 1),
                            self.prefill_chunk)
                    else:
                        clock.on_prefill(r.prompt.size - 1)
                        tok_h[b] = int(r.prompt[-1])
                        steps_h[b] = r.max_new
                        unc_h[b] = 0.0
                    if self.cache is not None:
                        self._leaders.append((SemanticCache._norm(r.key),
                                              r.rid))
                for r in reversed(putback):
                    self._queue.appendleft(r)

            if cloud_wave:
                # cloud-assigned lane: one grouped batched cloud generation
                t_cw = clock.now()
                tk = self.adaptation.capture_topk \
                    if self.adaptation is not None else 0
                toks = self._group_generate(
                    self.cloud, cloud_params,
                    [q.prompt for q in cloud_wave],
                    [q.max_new for q in cloud_wave], topk=tk)
                teach = [None] * len(cloud_wave)
                if tk:
                    toks, teach = toks
                for q, t, th in zip(cloud_wave, toks, teach):
                    self._finish(results, q, RequestTrace(
                        "cloud", cloud_passes=q.max_new, tokens=t,
                        teacher_topk=th),
                        t_first=t_cw + clock.step_ms)

            # ---- advance chunked prefills: one detached chunk per job per
            # tick; a finished job lands its cache and arms the slot, and
            # its detached buffers go back to the lane once they have landed
            landed = []
            for b in list(self._prefill_jobs):
                job = self._prefill_jobs[b]
                before = job["done"]
                finished = self.edge.advance_prefill(edge_params, job)
                clock.on_prefill(job["done"] - before)
                if finished:
                    state.finalize(b, job["cache"])
                    landed.append(self._prefill_jobs.pop(b))
                    r = slots[b].req
                    tok_h[b] = int(r.prompt[-1])
                    steps_h[b] = r.max_new
                    unc_h[b] = 0.0
            if landed:
                state.flush()
                for job in landed:
                    self.edge.end_prefill(job)

            occupied = [b for b in range(B) if slots[b].req is not None]
            if not occupied:
                if deferred:
                    raise RuntimeError(
                        "paged KV pool too small for the queued request "
                        "even with an empty batch; raise kv_blocks")
                if stalled:
                    rid0 = min(self._swapped)
                    raise RuntimeError(
                        f"paged KV pool cannot restore swapped-out request "
                        f"{rid0} even with an empty batch (its blocks + "
                        "outstanding reservation exceed the pool); raise "
                        "kv_blocks")
                if self._queue:
                    # every queued arrival is in the future: jump/sleep
                    clock.wait_until(float(self._queue[0].at))
                continue            # all cache hits / cloud completions
            state.flush()

            # ---- one batched decode tick (pow2-bucketed step count;
            # overshoot decodes masked garbage).  The live step budget
            # comes from the HOST MIRROR — no pre-tick sync
            # repro-lint: ok(R1, steps_h is the numpy host mirror - no device pull)
            live = int(steps_h[occupied].max())
            if live <= 0:
                continue            # every occupied slot is mid-prefill
            n = pow2_steps(min(self.tick_tokens, live), self.tick_tokens)
            state.prepare_tick(occupied, steps_h, n)
            t_tick0 = time.perf_counter()
            state.caches, _, steps, unc, toks, actives = self.edge.chunk(
                edge_params, state.caches,
                torch.as_tensor(tok_h.reshape(B, 1, 1), device=dev),
                torch.as_tensor(steps_h, device=dev),
                torch.as_tensor(unc_h, device=dev), self._gen, stop,
                n_steps=n)
            # THE host readback: one batched pull per tick covers
            # retirement (steps/unc), the emitted streams (toks/actives)
            # and the pending-token mirror (the last emission)
            # repro-lint: ok(R1, the tick's one batched pull)
            steps_d, unc_d, toks_h, act_h = host_pull(steps, unc, toks,
                                                      actives)
            self._kv_stats["ticks"] += 1
            self._kv_stats["tick_seconds"] += time.perf_counter() - t_tick0
            clock.on_steps(n)
            t_tick = clock.now()
            steps_h = np.array(steps_d)
            unc_h = np.array(unc_d)
            tok_h = np.array(toks_h[-1])
            for b in occupied:
                new = [int(t) for t, a in zip(toks_h[:, b], act_h[:, b])
                       if a]
                if new and not slots[b].tokens:
                    # tick-granular first-token stamp
                    self._events[slots[b].req.rid]["first_token_ms"] = t_tick
                slots[b].tokens.extend(new)

            # ---- retire finished slots; the policy names each one's action
            retiring: List[Tuple[_Request, float, List[int]]] = []
            for b in occupied:
                if steps_h[b] > 0 or b in self._prefill_jobs:
                    continue
                req = slots[b].req
                req.spent = min(len(slots[b].tokens), req.max_new)
                u = float(unc_h[b]) / max(req.spent, 1)
                retiring.append((req, u, slots[b].tokens[:req.spent]))
                slots[b] = _Slot()
                state.retire(b)

            if retiring:
                # one vectorized decide over the wave's collaborative
                # requests; edge-assigned ones force-accept their output
                actions = ["accept"] * len(retiring)
                decided = [i for i, (rq, _, _) in enumerate(retiring)
                           if rq.lane != "edge"]
                if decided:
                    acts = list(self.policy.decide(
                        np.array([retiring[i][1] for i in decided],
                                 np.float32),
                        np.array([retiring[i][0].spent
                                  for i in decided], np.int32),
                        np.array([retiring[i][0].max_new
                                  for i in decided], np.int32)))
                    if len(acts) != len(decided):
                        raise ValueError(
                            f"policy {self.policy.name!r} decided "
                            f"{len(acts)} actions for a wave of "
                            f"{len(decided)}")
                    for i, a in zip(decided, acts):
                        a = str(a)
                        if a not in ACTIONS:
                            raise ValueError(
                                f"policy {self.policy.name!r} decided "
                                f"unknown action {a!r}; known: "
                                f"{' | '.join(ACTIONS)}")
                        actions[i] = a
                groups: Dict[str, List[Tuple[_Request, float]]] = {}
                for (req, u, toks), a in zip(retiring, actions):
                    if a == "accept":
                        self._finish(results, req, RequestTrace(
                            "edge", edge_calls=req.spent, uncertainty=u,
                            tokens=toks))
                    else:
                        # edge tokens leave the client stream; kept as the
                        # rejected draft for the feedback payload
                        req.draft = toks
                        groups.setdefault(a, []).append((req, u))
                # one batched group per decided action
                for a, grp in groups.items():
                    t_esc = clock.now()
                    for req, tr in self._esc_fns[a](
                            edge_params, cloud_params,
                            [g[0] for g in grp], [g[1] for g in grp]):
                        self._finish(results, req, tr,
                                     t_first=t_esc + clock.step_ms)

        self._kv_stats["kv_peak_bytes"] = state.peak_bytes
        self._kv_stats["kv_capacity_bytes"] = state.capacity_bytes
        self._kv_stats["preemptions"] = self._preempts
        self._kv_stats.update(state.stats())
        self.edge.release(state)
        return results

    @property
    def _swaps_in_place(self) -> bool:
        """An adaptation swap lands IN PLACE in the served edge parameters
        (off-mesh): the captured tick and round read them where they lie,
        and would go on reading old weights from a replaced tree.  On a
        mesh, where they run eager, each swap serves a new view."""
        return self.adaptation is not None and self.mesh is None

    def _serve_edge(self, params):
        """The served edge parameters holding ``params``' values: a private
        copy made at the first drain (the caller's tensors are never
        written), copied into in place from then on."""
        from repro_torch.training import tree as T
        if self._served is None:
            self._served = T.replace(params, [t.detach().clone()
                                              for t in T.tensors(params)])
        elif params is not self._served:
            with torch.no_grad():
                for dst, src in zip(T.tensors(self._served),
                                    T.tensors(params)):
                    dst.copy_(src)
        return self._served

    @hot_path
    def _pick_victim(self, state, slots, steps_h, wave) -> Optional[int]:
        """Preemption victim by a cost model: remaining decode steps per
        block of KV it would checkpoint (``steps / (1 + owned_blocks)``),
        ties to the most steps, then the youngest request.  Slots admitted
        or resumed this wave, mid-chunked-prefill, or whose restore could
        never fit the pool are exempt.  ``steps_h`` is the host mirror."""
        best = None
        for b, s in enumerate(slots):
            if s.req is None or b in wave or b in self._prefill_jobs \
                    or not state.swappable(b):
                continue
            key = (float(steps_h[b]) / (1.0 + state.owned_blocks(b)),
                   int(steps_h[b]), s.req.rid)
            if best is None or key > best[0]:
                best = (key, b)
        return None if best is None else best[1]

    def serve_batch(self, edge_params, cloud_params, prompts,
                    max_new, domains=None) -> List[RequestTrace]:
        """Convenience: submit ``prompts``, drain, return traces in order.
        ``max_new`` may be an int or a per-request sequence."""
        if isinstance(max_new, int):
            max_new = [max_new] * len(prompts)
        if len(max_new) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts but {len(max_new)} "
                             "max_new budgets")
        if domains is None:
            domains = [None] * len(prompts)
        if len(domains) != len(prompts):
            raise ValueError(f"{len(prompts)} prompts but {len(domains)} "
                             "domain tags")
        rids = [self.submit(p, m, domain=d)
                for p, m, d in zip(prompts, max_new, domains)]
        results = self.run(edge_params, cloud_params)
        return [results[rid] for rid in rids]

    # ------------------------------------------------------------ internals
    def _finish(self, results, req: _Request, tr: RequestTrace, *,
                t_first: Optional[float] = None):
        """Complete ``req``: stamp lifecycle events, fire policy feedback,
        warm the cache, resolve followers."""
        now = self.clock.now()
        ev = self._events.setdefault(
            req.rid, {"submit_ms": now, "swaps": 0, "defers": 0})
        if t_first is not None:
            ev["first_token_ms"] = t_first
        elif "first_token_ms" not in ev:
            ev["first_token_ms"] = now
        ev["retire_ms"] = now
        ev["path"] = tr.path
        ev["tokens"] = len(tr.tokens) if tr.tokens else 0
        if tr.path != "cache":
            ttft = ev["first_token_ms"] - ev["submit_ms"]
            slo_met = self.slo_ms is None or ttft <= self.slo_ms
            self.policy.feedback(
                "accept" if tr.path == "edge" else tr.path,
                trace_quality(tr, req.max_new),
                cloud_tokens(tr, self.gamma),
                {"rid": req.rid, "unc": tr.uncertainty,
                 "steps": req.spent if req.spent else req.max_new,
                 "budget": req.max_new, "lane": req.lane,
                 "ttft_ms": ttft, "e2e_ms": now - ev["submit_ms"],
                 "slo_ms": self.slo_ms, "slo_met": slo_met,
                 "prompt": req.prompt, "tokens": tr.tokens,
                 "draft": req.draft, "teacher_topk": tr.teacher_topk,
                 "domain": req.domain})
            if self.adaptation is not None and tr.tokens:
                self.adaptation.observe(
                    prompt=req.prompt, tokens=tr.tokens, draft=req.draft,
                    teacher_topk=tr.teacher_topk, domain=req.domain,
                    sla="none" if self.slo_ms is None
                    else ("met" if slo_met else "missed"),
                    path=tr.path)
        if self.cache is not None and tr.tokens is not None \
                and req.key is not None:
            self.cache.insert(req.key, tr.tokens)
        results[req.rid] = tr
        # resolve coalesced followers from the leader's result
        self._leaders = [(k, rid) for k, rid in self._leaders
                         if rid != req.rid]
        for f in self._followers.pop(req.rid, []):
            fev = self._events.setdefault(
                f.rid, {"submit_ms": now, "swaps": 0, "defers": 0})
            fev.setdefault("first_token_ms", now)
            fev["retire_ms"] = now
            fev["path"], fev["tokens"] = "cache", ev["tokens"]
            results[f.rid] = RequestTrace(
                "cache", tokens=list(tr.tokens) if tr.tokens else None)

    @hot_path
    def _group_generate(self, lane: Lane, params, prompts,
                        max_news: List[int], topk: int = 0):
        """Batched generation for an escalation group: per-request prefill,
        then ONE decode loop over the padded group and ONE batched pull of
        the emitted tape.  Returns the per-request token lists; with
        ``topk > 0`` the loop also emits top-k teacher logits and the
        return is ``(tokens, teachers)``, ``teachers[i]`` a (values,
        indices) pair trimmed to request i's emitted length — they ride
        the SAME pull."""
        if max(max_news) == 0:
            empty = [[] for _ in prompts]
            return (empty, [None] * len(prompts)) if topk else empty
        n = pow2_steps(max(max_news), 1 << 30)
        G = self.batch_size                         # pad: stable shapes
        need = [len(p) - 1 + m for p, m in zip(prompts, max_news) if m > 0]
        state = lane.make_state(params, G, self._slot_len, need_tokens=need)
        tok_h = np.zeros((G, 1, 1), np.int32)
        steps_h = np.zeros((G,), np.int32)
        members = []
        for i, (p, m) in enumerate(zip(prompts, max_news)):
            if m <= 0:
                continue
            state.admit(i, p, len(p) - 1 + m)
            self.clock.on_prefill(len(p) - 1)
            members.append(i)
            tok_h[i, 0, 0] = int(p[-1])
            steps_h[i] = m
        state.flush()
        state.prepare_tick(members, steps_h, n)
        dev = params.embed.device
        # escalation/cloud groups never stop early (stop disarmed, -1)
        outs = lane.chunk(
            params, state.caches, torch.as_tensor(tok_h, device=dev),
            torch.as_tensor(steps_h, device=dev),
            torch.zeros((G,), dtype=torch.float32, device=dev), self._gen,
            torch.full((), -1, dtype=torch.int32, device=dev), n_steps=n,
            topk=topk)
        self.clock.on_steps(n)
        self._note_group(state)
        lane.release(state)
        # repro-lint: ok(R1, the one batched pull of the group's tapes)
        pulled = host_pull(*outs[4:])
        toks_h, act_h = pulled[:2]
        tokens = [[int(t) for t, a in zip(toks_h[:, i], act_h[:, i]) if a]
                  for i in range(len(prompts))]
        if not topk:
            return tokens
        # emissions are a True-prefix of the loop (budgets only count
        # down), so request i's teacher rows are its first len(tokens)
        tv_h, ti_h = pulled[2:]
        return tokens, [(np.array(tv_h[:len(t), i]),
                         np.array(ti_h[:len(t), i]))
                        for i, t in enumerate(tokens)]

    def _cloud_escalate(self, edge_params, cloud_params, reqs, uncs):
        """Grouped full-cloud regeneration.  With an adaptation loop
        attached, the SAME cloud pass also emits top-k teacher logits for
        the rejected edge draft's distillation."""
        tk = self.adaptation.capture_topk \
            if self.adaptation is not None else 0
        toks = self._group_generate(self.cloud, cloud_params,
                                    [r.prompt for r in reqs],
                                    [r.max_new for r in reqs], topk=tk)
        teach = [None] * len(reqs)
        if tk:
            toks, teach = toks
        return [(r, RequestTrace("cloud", edge_calls=r.max_new,
                                 cloud_passes=r.max_new, uncertainty=u,
                                 tokens=t, teacher_topk=th))
                for r, u, t, th in zip(reqs, uncs, toks, teach)]

    def _skeleton_escalate(self, edge_params, cloud_params, reqs, uncs):
        """Grouped skeleton division: one batched cloud skeleton pass plus
        one batched edge completion pass for the whole group."""
        ks = [min(self.skeleton_len, r.max_new) for r in reqs]
        skels = self._group_generate(self.cloud, cloud_params,
                                     [r.prompt for r in reqs], ks)
        exts = [np.concatenate([r.prompt, np.asarray(s, np.int32)])
                for r, s in zip(reqs, skels)]
        rests = self._group_generate(
            self.edge, edge_params, exts,
            [r.max_new - k for r, k in zip(reqs, ks)])
        return [(r, RequestTrace(
            "skeleton", edge_calls=r.max_new + (r.max_new - k),
            cloud_passes=k, uncertainty=u, tokens=s + rest))
            for r, u, k, s, rest in zip(reqs, uncs, ks, skels, rests)]

    @hot_path
    def _spec_escalate(self, edge_params, cloud_params, reqs, uncs):
        """One BatchedSpecDecoder group over all escalated requests.  Paged
        groups pre-grow each slot to prompt + budget + one round of draft
        overdraft — spec rewinds only move ``pos``, never reallocate.  A
        tree lane overdrafts a full padded tree per round and runs on the
        dense side lanes; the self lane builds ONE edge-side state (draft
        and verify share cache and parameters — no cloud involvement, so
        its traces carry ``cloud_passes=0``)."""
        G = self.batch_size
        mode = self.spec_mode
        ovr = (self.spec.plan.n_pad if mode == "tree" else self.gamma) + 2
        need = [r.prompt.size - 1 + r.max_new + ovr for r in reqs]
        d_state = self._spec_edge.make_state(edge_params, G, self._slot_len,
                                             need_tokens=need)
        states = [d_state]
        lanes = [self._spec_edge]
        if mode != "self":
            t_state = self._spec_cloud.make_state(
                cloud_params, G, self._slot_len, need_tokens=need)
            states.append(t_state)
            lanes.append(self._spec_cloud)
        last_h = np.zeros((G, 1, 1), np.int32)
        for i, (r, nd) in enumerate(zip(reqs, need)):
            for st in states:
                st.admit(i, r.prompt, nd)
            last_h[i, 0, 0] = int(r.prompt[-1])
        last = torch.as_tensor(last_h, device=edge_params.embed.device)
        overdraft = np.zeros((G,), np.int32)
        overdraft[:len(reqs)] = [n - (r.prompt.size - 1)
                                 for n, r in zip(need, reqs)]
        for st in states:
            st.flush()
            st.prepare_tick(list(range(len(reqs))), overdraft, 1 << 30)
        max_news = [r.max_new for r in reqs] + [0] * (G - len(reqs))
        for r in reqs:
            self.clock.on_prefill(r.prompt.size - 1)
        if mode == "self":
            outs, stats = self.spec.generate_group_self(
                edge_params, d_state.caches, last, max_news, self._gen)
        else:
            outs, stats = self.spec.generate_group(
                edge_params, cloud_params, d_state.caches, t_state.caches,
                last, max_news, self._gen)
        # modeled cost: the group runs the slowest member's rounds, each a
        # draft chunk (gamma steps, or the tree's depth levels) + one
        # verify + one commit step
        draft_steps = self.spec.plan.depth if mode == "tree" else self.gamma
        self.clock.on_steps(max(st["rounds"] for st in stats[:len(reqs)])
                            * (draft_steps + 2))
        self._note_group(*states)
        for lane, st in zip(lanes, states):
            lane.release(st)
        return [(r, RequestTrace(
            "speculative",
            edge_calls=r.max_new + stats[i]["rounds"] * (draft_steps + 1),
            cloud_passes=0 if mode == "self" else stats[i]["rounds"],
            uncertainty=u, tokens=outs[i]))
            for i, (r, u) in enumerate(zip(reqs, uncs))]

    # ------------------------------------------------------------ stats
    @property
    def events(self) -> Dict[int, dict]:
        """Per-request lifecycle events of the last ``run``."""
        return self._events

    def stats(self) -> Dict[str, Any]:
        c = self.spec.counters
        return {"cache_hit_rate": self.cache.hit_rate if self.cache else 0.0,
                "policy": self.policy.name,
                "spec_mode": self.spec_mode,
                "spec_accept_rate": c["accepted_tokens"] / c["draft_tokens"]
                if c["draft_tokens"] else 0.0,
                "accepted_tokens_per_step":
                c["emitted_tokens"] / c["member_rounds"]
                if c["member_rounds"] else 0.0,
                "spec_lanes": {self.spec_mode: dict(c)},
                "captures": {"edge": self.edge.captures,
                             "cloud": self.cloud.captures,
                             "spec": self.spec.captures},
                "capture_seconds": self.edge.capture_seconds
                + self.cloud.capture_seconds + self.spec.capture_seconds,
                "graphs": {"edge": self.edge.graph_rule(self._dev),
                           "cloud": self.cloud.graph_rule(self._dev),
                           "spec": "eager (mesh)" if self.mesh is not None
                           else self.spec.graph_rule(self._dev),
                           "edge prefill": self.edge.prefill_rule(self._dev),
                           "cloud prefill":
                           self.cloud.prefill_rule(self._dev)},
                **self.policy.stats(), **self._kv_stats,
                **({"adaptation": self.adaptation.stats()}
                   if self.adaptation is not None else {}),
                **latency_rollup(self._events, self.slo_ms)}
