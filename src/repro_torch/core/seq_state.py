"""Family-agnostic per-sequence decode state for the serving scheduler
(the PyTorch twin of the JAX package's ``core/seq_state.py``).

  * ``SequenceState`` — the host-side slot-state owner: ``admit`` (prefill
    + capacity reservation), ``flush`` (batched device writes),
    ``prepare_tick`` (per-tick capacity growth), ``retire`` (free), and the
    ``peak_bytes`` / ``capacity_bytes`` / ``stats`` accounting.  Layouts:

      - ``DenseKV`` — stacked per-slot caches padded to a common
        ``slot_len`` (the parity oracle): one (L, B, slot_len, Kv, hd)
        cache with per-slot ``pos`` (B,), where JAX stacks single-sequence
        caches and vmaps over them.
      - ``PagedKV`` — one shared block pool + per-slot block tables
        (``core/paged_cache.py``), with refcounted prefix sharing +
        copy-on-write and host-buffer swap for preemption.
      - ``RecurrentState`` — fixed-size recurrent state (ssm / xlstm /
        hybrid), stacked like the dense layout: recurrent state has no
        sequence axis to page, so slots are whole per-slot states.

  * ``SpecOps`` — the per-model ops speculative decoding composes:
    ``step`` / ``extend`` and ``snapshot`` / ``commit``.  KV layouts
    snapshot ``pos`` and commit with a ``pos`` write, plus the tree lane's
    ``extend_tree`` / ``reset`` / ``commit_permute`` on the dense layout;
    the recurrent layout snapshots the state and commits by replaying each
    slot's accepted prefix through the model's batched ``replay_step``.
  * ``Lane`` — the per-model batched machinery (bucketed prefill, chunked
    prefill, the multi-step decode loop with ONE host pull per tick) plus
    the ``make_state`` factory and ``dense_side`` (the same model on dense
    per-slot caches, for tree/self escalation groups).  All layout
    dispatch lives here.  Released states' buffers and chunked prefills'
    detached caches are kept for reuse in bounded ``SparePool``s.

Cache trees: every leaf has the slot axis first, except the attention
slabs ``k`` / ``v`` (a leading layer or group axis, then the slot axis).
Device tensors are updated IN PLACE where JAX returns new arrays (pools,
tables, dense and hybrid K/V slabs, slot writes at admission); the
recurrent models' steps return new state tensors, which ``SpecOps`` copies
back into the state's own (a captured tick or round is tied to their
addresses, ``core/capture.py``), so the recurrent snapshot copies every
leaf; ``pos`` is always replaced by a new tensor.

On a device mesh (``BatchedEngine(mesh=)``): the host bookkeeping is
global and identical on every rank, while each rank's device cache holds
only its LOCAL view (under ``caches["shard"]``): its data shard's slot
rows when the lane's slots split over the data axes, and its model rank's
part of the attention K/V (kv-heads, else the head dim; ``kv_ways`` of
them).  A lane whose attention runs on the local kv-heads — the
tensor-parallel cloud, and the edge through
``launch/sharding.local_attention`` — computes on exactly those heads; a
lane whose attention is replicated over 'model' on split K/V (an edge
whose kv-heads do not divide 'model', the hybrid's shared block) gathers
full-width K/V for every step, runs it, and writes its own part back.

  - ``PagedKV`` (``ShardView``): one global pool with a
    ``ShardedBlockPool`` when the edge's slots split, a rank holding its
    shard's block range (local ids: the global id less ``shard *
    per_shard``, so each shard's trap is its local block 0); a replicated
    step gathers only the blocks its slots' tables name
    (``ShardView.run``).
  - ``DenseKV`` / ``RecurrentState`` (``DenseView``): a rank holds its
    slot rows of every leaf, sized from the lane's local config; the
    recurrent states' own leaves stay whole over 'model' (the edge's
    weights are whole on every rank, so a split would cost a gather a
    step and save no compute), the hybrid's K/V slabs split as above.

``Lane.chunk`` runs a data-split state on this rank's slots and
all-gathers the tick's tapes over the data axes, so every rank's host pull
sees the whole batch and makes the same decisions.
"""
from __future__ import annotations

import hashlib
from collections import Counter, OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.analysis import hot_path
from repro_torch.core.capture import capture, evict
from repro_torch.core.paged_cache import (BlockPool, ShardedBlockPool,
                                          blocks_for, copy_pool_blocks,
                                          prompt_cache_to_blocks,
                                          read_pool_blocks, write_pool_blocks)
from repro_torch.launch.sharding import kv_shard_ways
from repro_torch.core.uncertainty import get_batched_estimator
from repro_torch.models import transformer
from repro_torch.models.model import Model, require_token_prompts
from repro_torch.models.ssm import tree_leaves, tree_map

# cache entries holding attention slabs (slot axis second, written in place)
SLABS = ("k", "v")
# the cache entry holding a state's local view on a device mesh
VIEW = "shard"
# released states a lane keeps for its next states (``SparePool``).  A
# drain holds at most a handful of one lane's states: the edge's, and per
# escalation wave a group state, whose paged pool is a pow2 of the wave's
# residency (1 + log2(batch) sizes, 4 at batch 8).  8 keeps all of them, so
# a repeated drain of one shape reuses every buffer and captures nothing;
# drains of ever new lengths leave at most 8 states, and their graphs, per
# lane instead of one set per length ever seen
MAX_SPARE_STATES = 8
# detached chunked-prefill caches a lane keeps: one per slot prefilling at
# once, which is every slot of the default batch of 8 at worst
MAX_SPARE_DETACHED = 8


# ---------------------------------------------------------------- host pull
def host_pull(*tensors) -> List[np.ndarray]:
    """Bring a wave's device outputs to the host in ONE transfer: every
    tensor is flattened into a single int32 buffer (float32 by bit view,
    bool and int64 by value), copied once, and split back to numpy arrays
    of the original shapes — the one batched pull per tick or wave."""
    flat = []
    for t in tensors:
        t = t.reshape(-1)
        if t.dtype == torch.float32:
            t = t.view(torch.int32)
        elif t.dtype != torch.int32:
            t = t.to(torch.int32)
        flat.append(t)
    buf = torch.cat(flat).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        part = buf[off:off + t.numel()]
        off += t.numel()
        if t.dtype == torch.float32:
            part = part.view(np.float32)
        elif t.dtype == torch.bool:
            part = part.astype(bool)
        out.append(part.reshape(tuple(t.shape)))
    return out


def next_tokens(logits, temperature: float, gen, view=None):
    """Greedy argmax at T=0, else a categorical draw (Gumbel-max with
    uniforms from ``gen``).  Returns (B,) int32.  On a data-split
    ``view`` the logits are this rank's rows: the uniforms are drawn for
    the whole batch and cut to them, so every rank's generator advances
    alike."""
    if temperature == 0.0:
        return logits.argmax(-1).to(torch.int32)
    if view is not None and view.sharded:
        u = view.rows(torch.rand((view.batch,) + tuple(logits.shape[1:]),
                                 generator=gen, device=logits.device))
    else:
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
    g = -torch.log(-torch.log(u))
    return (logits.float() / temperature + g).argmax(-1).to(torch.int32)


# ---------------------------------------------------------------- slot utils
def stack_slot_caches(model, batch: int, slot_len: int, device):
    """Zero-initialized stacked per-slot caches with per-slot ``pos``."""
    c = model.init_cache(batch, slot_len, device=device)
    return {**c, "pos": torch.zeros((batch,), dtype=torch.int32,
                                    device=device)}


def write_slots(slots, bs: List[int], caches: List):
    """Overwrite slots ``bs`` with freshly prefilled single-sequence caches
    in ONE scatter per tensor, IN PLACE (each value cast to the slot
    tensor's dtype, as JAX's scatter does; ``pos`` replaced).  Also wipes
    any garbage a retired occupant decoded past its budget."""
    dev = slots["pos"].device
    idx = torch.as_tensor(bs, dtype=torch.long, device=dev)

    def put(axis):
        def write(big, *smalls):
            big[(slice(None),) * axis + (idx,)] = torch.cat(
                smalls, dim=axis).to(big.dtype)
        return write

    for key, big in slots.items():
        if key not in ("pos", VIEW):
            tree_map(put(1 if key in SLABS else 0), big,
                     *(c[key] for c in caches))
    pos = slots["pos"].clone()
    pos[idx] = torch.stack([c["pos"] for c in caches]).to(torch.int32)
    return {**slots, "pos": pos}


def copy_leaves(caches, src) -> None:
    """Copy every state leaf of the cache tree ``src`` into ``caches``'
    own tensor of that leaf, IN PLACE (``pos`` and a mesh view aside)."""
    for key, dst in caches.items():
        if key not in ("pos", VIEW):
            for d, s in zip(tree_leaves(dst), tree_leaves(src[key])):
                if d is not s:
                    d.copy_(s)


def pow2_steps(n: int, cap: int) -> int:
    """Round a residual step count up to a power of two (capped): bucketing
    bounds the set of distinct loop lengths; the active mask absorbs the
    overshoot."""
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


# ---------------------------------------------------------------- layouts
def layout_for(model, kv_layout: str) -> str:
    """Effective per-model layout under the engine-level ``kv_layout``:
    "paged" where the engine runs paged and the family supports it,
    "recurrent" for state-cache families, else "dense"."""
    if kv_layout == "paged" and model.paged_kv:
        return "paged"
    if not model.rewindable_cache:
        return "recurrent"
    return "dense"


def resolve_kv_layout(edge_model, cloud_model, kv_layout: str) -> str:
    """Resolve the engine-level KV layout ("auto" -> paged where BOTH
    models' families page); validates explicit requests."""
    if kv_layout not in ("auto", "paged", "dense"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}; "
                         "known: auto | paged | dense")
    paged_ok = edge_model.paged_kv and cloud_model.paged_kv
    if kv_layout == "paged" and not paged_ok:
        raise ValueError(
            "kv_layout='paged' needs KV-cache transformer families on "
            f"both models, got {edge_model.cfg.family!r} / "
            f"{cloud_model.cfg.family!r}")
    if kv_layout == "auto":
        return "paged" if paged_ok else "dense"
    return kv_layout


# ---------------------------------------------------------------- mesh views
def local_kv(cfg, kv_ways: int):
    """The config of a rank's part of the attention K/V split ``kv_ways``
    ways over 'model' — kv-heads when they divide, else the head dim, as
    ``launch/sharding.cache_spec`` places them — and the dim of a (L, B,
    S|bs, Kv, hd) slab it cuts (3, 4, or None when unsplit)."""
    if kv_ways <= 1:
        return cfg, None
    if cfg.num_kv_heads % kv_ways == 0:
        return cfg.replace(num_kv_heads=cfg.num_kv_heads // kv_ways), 3
    return cfg.replace(head_dim=cfg.head_dim // kv_ways), 4


class LocalView:
    """One rank's LOCAL view of a state on a device mesh (see the module
    docstring): which slots it holds and which part of the K/V bytes.

    ``sharded``: the slots split over the data axes (this rank holds rows
    ``[lo, hi)`` of the batch); ``kv_dim`` (3 heads, 4 head dim, None) and
    ``kv_ways``: the split of the K/V over 'model'; ``gather``: the lane's
    attention is replicated over 'model' (params replicated or the
    head-count fallback), so a step computes full-width K/V and the state
    keeps this rank's part."""

    def __init__(self, mesh, batch: int, data_shards: int, kv_ways: int,
                 kv_dim: Optional[int], gather: bool):
        self.mesh = mesh
        self.batch = batch
        self.sharded = data_shards > 1
        n = batch // data_shards if self.sharded else batch
        self.shard = mesh.axis_index(runtime.data_axes()) \
            if self.sharded else 0
        self.lo, self.hi = self.shard * n, (self.shard + 1) * n
        self.kv_ways = kv_ways
        self.kv_dim = kv_dim if kv_ways > 1 else None
        self.gather = gather and self.kv_dim is not None
        self.part = mesh.axis_index("model")

    def mine(self, b: int) -> bool:
        return self.lo <= b < self.hi

    def rows(self, x):
        """This rank's slot rows of a whole-batch tensor."""
        return x[self.lo:self.hi] if self.sharded else x

    def kv_part(self, x):
        """This rank's part of full-width K/V (..., Kv, hd) — the identity
        when the lane computed only its own heads."""
        if not self.gather:
            return x
        dim = x.dim() - 5 + self.kv_dim
        w = x.shape[dim] // self.kv_ways
        return x.narrow(dim, self.part * w, w)

    def gather_kv(self, k, v):
        """Full-width K and V from every model rank's part: ONE all-gather
        over 'model' of the two stacked."""
        full = self.mesh.all_gather(torch.stack([k, v]), "model",
                                    dim=1 + self.kv_dim)
        return full[0], full[1]


class ShardView(LocalView):
    """The local view of a paged state: also the block range ``[base,
    base + per_shard)`` this rank's data shard owns."""

    def __init__(self, mesh, batch: int, data_shards: int, per_shard: int,
                 kv_ways: int, kv_dim: Optional[int], gather: bool):
        super().__init__(mesh, batch, data_shards, kv_ways, kv_dim, gather)
        self.base = self.shard * per_shard

    def local_ids(self, ids) -> List[int]:
        return [int(i) - self.base for i in ids]

    def run(self, fn, caches):
        """Run a paged step ``fn(caches) -> (logits, caches)`` on full-width
        K/V: gather the blocks this rank's table rows name (one all-gather
        of their parts over 'model', K and V together) into a working pool
        whose table is the identity, run ``fn`` on it, and write this
        rank's part of every working block back.  Duplicate ids (shared
        prefix blocks, the trap) differ only at positions past their
        owners' lengths, so any copy may land."""
        if not self.gather:
            return fn(caches)
        table = caches["table"]
        ids = table.reshape(-1).long()
        k, v = self.gather_kv(caches["k"][:, ids], caches["v"][:, ids])
        work = {"k": k, "v": v, "pos": caches["pos"],
                "table": torch.arange(ids.numel(), dtype=torch.int32,
                                      device=ids.device).view(table.shape)}
        lg, work = fn(work)
        caches["k"][:, ids] = self.kv_part(work["k"])
        caches["v"][:, ids] = self.kv_part(work["v"])
        return lg, {**caches, "pos": work["pos"]}


class DenseView(LocalView):
    """The local view of a dense or recurrent state: this rank's slot rows
    of every leaf, and its part of the K/V slabs."""

    def own(self, cache):
        """This rank's part of a freshly prefilled single-sequence cache."""
        if not self.gather or "k" not in cache:
            return cache
        return {**cache, "k": self.kv_part(cache["k"]),
                "v": self.kv_part(cache["v"])}

    def run(self, fn, caches):
        """Run ``fn(caches) -> (out, caches)`` on this rank's rows: the view
        entry is set aside (the recurrent steps build new dicts), and a
        replicated lane on split K/V slabs first gathers them to full
        width (one all-gather over 'model', K and V together), then writes
        its own part of what the step left in them back."""
        work = {k: v for k, v in caches.items() if k != VIEW}
        if self.gather:
            work["k"], work["v"] = self.gather_kv(work["k"], work["v"])
        out, new = fn(work)
        if self.gather:
            caches["k"].copy_(self.kv_part(new["k"]))
            caches["v"].copy_(self.kv_part(new["v"]))
            new = {**new, "k": caches["k"], "v": caches["v"]}
        return out, {**new, VIEW: self}


# ---------------------------------------------------------------- spec ops
class SpecOps:
    """Per-(model, layout) ops for batched speculative decoding:
    ``step``/``extend`` run one decode step / a multi-token extend over the
    whole group; ``snapshot``/``commit`` implement the per-round rewind.
    ``attn_backend`` picks the kernels' or the plain path of the decode
    steps, the extends and the replay (see ``Model.paged_decode_step`` /
    ``decode_step`` / ``extend_step`` / ``replay_step``)."""

    def __init__(self, model, layout: str, attn_backend: str = "auto"):
        self.model = model
        self.layout = layout
        self.attn_backend = attn_backend

    def run(self, caches, fn):
        """``fn(caches) -> (out, caches)`` on the state's local view on a
        device mesh (``ShardView.run`` / ``DenseView.run``), else
        directly."""
        view = caches.get(VIEW)
        return fn(caches) if view is None else view.run(fn, caches)

    def _in_place(self, caches, new):
        """``new``, the state a recurrent step, extend or replay built, as
        ``caches`` with every leaf copied into ``caches``' own tensor (the
        values unchanged) and ``pos`` taken from ``new``: a captured tick
        or round then reads and writes one set of buffers call after call.
        KV layouts already write in place and return ``new``."""
        if self.layout != "recurrent":
            return new
        copy_leaves(caches, new)
        return {**caches, "pos": new["pos"]}

    def step(self, params, tok, caches):
        """tok (G, 1, 1) -> (logits (G, V), caches)."""
        step = self.model.paged_decode_step if self.layout == "paged" \
            else self.model.decode_step
        lg, new = self.run(caches, lambda c: step(
            params, tok[:, :, 0], c, attn_backend=self.attn_backend))
        return lg, self._in_place(caches, new)

    def extend(self, params, tokens, caches):
        """tokens (G, T) -> (logits (G, T, V), caches)."""
        if self.layout == "paged":
            return self.run(caches, lambda c: self.model.paged_extend_step(
                params, tokens, c))
        lg, new = self.run(caches, lambda c: self.model.extend_step(
            params, tokens, c, attn_backend=self.attn_backend))
        return lg, self._in_place(caches, new)

    def extend_tree(self, params, tokens, caches, block_mask, depths):
        """Tree-masked extend: each slot's ``tokens`` (G, T) row is a packed
        token tree whose node ``i`` attends the cache prefix plus
        ``block_mask[i]`` (T, C) of the tree, with RoPE positions
        ``pos + depths`` (T,).  Dense layout only: token trees need a
        customizable intra-block mask, and paged extends are linear-order."""
        if self.layout != "dense":
            raise ValueError(
                f"token trees need a dense-layout attention model; got "
                f"layout {self.layout!r}")
        return self.run(caches, lambda c: self.model.extend_step(
            params, tokens, c, block_mask=block_mask,
            q_positions=c["pos"].long()[:, None] + depths.long()[None, :],
            attn_backend=self.attn_backend))

    def reset(self, caches, snap):
        """Roll the group back to the pre-round snapshot WITHOUT committing
        anything (the self lane re-anchors before its verify)."""
        if self.layout == "recurrent":
            return self._in_place(caches, snap)
        return {**caches, "pos": snap}

    def commit_replay(self, params, caches, snap, tokens, counts):
        """Replay-based commit: rewind to the snapshot, re-extend through
        the padded accepted tape ``tokens`` (G, T), then keep each slot's
        ``counts`` — the JAX package's tree-round rewind (the port's tree
        lane commits by ``commit_permute``).  Recurrent layouts already
        commit by replay."""
        if self.layout == "recurrent":
            return self.commit(params, caches, snap, tokens, counts)
        _, caches = self.extend(params, tokens, self.reset(caches, snap))
        return {**caches, "pos": (snap + counts).to(torch.int32)}

    def commit_permute(self, caches, snap, perm, counts):
        """Gather-based tree commit: the verify extend wrote every tree
        node's K/V at cache row ``snap + node`` with RoPE position ``snap +
        depth(node)``, and the accepted root path has exactly one node per
        depth — so its rows are already position-correct and merely sit at
        the wrong cache index.  Copy them down to the contiguous prefix
        [snap, snap + T) (IN PLACE) and advance ``pos``: no replay forward
        pass.  ``perm`` (G, T) holds each slot's path node indices (entries
        past ``counts`` land beyond ``pos`` and are dead).  Indices clip to
        the cache and the write start clamps, as the JAX package's
        ``take(mode="clip")`` and ``dynamic_update_slice`` do."""
        S = caches["k"].shape[2]
        T = perm.shape[1]
        s = snap.long()
        src = (s[:, None] + perm.long()).clamp(0, S - 1)             # (G,T)
        dst = s.clamp(0, S - T)[:, None] + torch.arange(T, device=s.device)
        g = torch.arange(src.shape[0], device=s.device)[:, None]
        for name in ("k", "v"):
            x = caches[name]                          # (L, G, S, Kv, hd)
            x[:, g, dst] = x[:, g, src]
        return {**caches, "pos": (snap + counts).to(torch.int32)}

    def snapshot(self, caches):
        """Pre-round rewind anchor: ``pos`` (G,) for KV layouts (never
        mutated later); for recurrent state a copy of every leaf (the
        hybrid's attention slabs too), which the round's steps write in
        place (``_in_place``)."""
        if self.layout == "recurrent":
            return {k: v if k in ("pos", VIEW) else
                    tree_map(torch.clone, v) for k, v in caches.items()}
        return caches["pos"]

    def commit(self, params, caches, snap, tokens, counts):
        """Rewind the post-round ``caches`` to each slot's accepted prefix:
        ``tokens`` (G, T) is the round's draft tape [pending, d_0..], and
        ``counts`` (G,) int32 (0 freezes a slot on its snapshot) how many
        of its entries each slot commits.  KV: one ``pos`` write (rejected
        entries stay, masked and overwritten).  Recurrent: the batched
        ``replay_step`` from the snapshot — each slot re-advances through
        its own prefix — landing in ``caches``' own tensors."""
        if self.layout == "recurrent":
            return self._in_place(caches, self.run(snap, lambda c: (
                None, self.model.replay_step(
                    params, tokens, c, counts,
                    attn_backend=self.attn_backend)))[1])
        return {**caches, "pos": (snap + counts).to(torch.int32)}


# ---------------------------------------------------------------- states
class SequenceState:
    """Adapter protocol for the scheduler's per-slot decode state.
    ``caches`` is the device dict the lane's step functions consume;
    everything else is host bookkeeping."""

    layout = "dense"
    caches: Any
    # the shape Lane.make_state built this state at, and its buffers' id
    # in the lane's SparePool; Lane.release files its device buffers under
    # them for the next state of that shape
    reuse_key: tuple = ()
    reuse_id: int = -1

    def admit(self, b: int, prompt, need_tokens: int) -> bool:
        """Stage slot ``b``'s prompt prefill; reserve worst-case capacity
        (``need_tokens`` cache entries).  False = defer (capacity full)."""
        raise NotImplementedError

    def begin(self, b: int, prompt, need_tokens: int) -> bool:
        """Reserve capacity for a CHUNKED prefill of slot ``b`` without
        staging any writes (the cache is built detached and lands via
        ``finalize``).  Same return contract as ``admit``."""
        return True

    def finalize(self, b: int, cache):
        """Land a finished detached prefill cache into slot ``b``."""
        raise NotImplementedError

    def detached_len(self, entry_count: int) -> int:
        """Padded length of a detached chunked-prefill cache for a prompt
        with ``entry_count`` entries."""
        raise NotImplementedError

    def share_hints(self, prompts: List[Any]) -> List[bool]:
        """True per prompt when a monolithic ``admit`` would likely share
        cache with live or same-wave state (skip chunked prefill)."""
        return [False] * len(prompts)

    def flush(self):
        """Land all staged admissions/retirements in batched device writes."""

    def prepare_tick(self, occupied, steps_h, n: int):
        """Grow capacity to cover this tick's real decode steps."""

    def retire(self, b: int):
        """Release slot ``b``'s capacity."""

    def fits_empty(self, need_tokens: int, prompt=None) -> bool:
        """True if a request reserving ``need_tokens`` entries could EVER be
        admitted."""
        return True

    def swappable(self, b: int) -> bool:
        """True if slot ``b`` may be chosen as a preemption victim."""
        return False

    def owned_blocks(self, b: int) -> int:
        """KV blocks slot ``b`` owns (0 on layouts without a block pool)."""
        return 0

    def swap_out(self, b: int):
        raise NotImplementedError(f"{type(self).__name__} does not swap")

    def swap_in(self, b: int, handle) -> bool:
        raise NotImplementedError(f"{type(self).__name__} does not swap")

    def rebind(self, params):
        """Point future prefills at hot-swapped ``params``."""
        self.params = params

    @property
    def capacity_bytes(self) -> int:
        return sum(t.nbytes for t in tree_leaves(self.caches))

    @property
    def peak_bytes(self) -> int:
        return self.capacity_bytes

    def stats(self) -> dict:
        return {}


class DenseKV(SequenceState):
    """Dense stacked slot caches: every slot padded to a common
    ``slot_len`` (kept as the parity oracle).

    With a ``mesh`` the device cache is this rank's local view
    (``DenseView``): its slot rows when ``data_shards > 1``, sized from
    the lane's local config (its part of the K/V over 'model', ``kv_ways``
    of them); admissions prefill every slot on every rank (a prefill may
    run collectives every rank must join) and land only this rank's rows.
    ``capacity_bytes`` stays global; ``stats()`` adds this rank's bytes."""

    layout = "dense"

    def __init__(self, lane: "Lane", params, batch: int, slot_len: int, *,
                 data_shards: int = 1, mesh=None, kv_gather: bool = False,
                 caches: Optional[dict] = None):
        self.lane = lane
        self.params = params
        self.slot_len = slot_len
        self.view = None
        model, rows = lane.model, batch
        if mesh is not None:            # sized from this rank's config
            ways = lane.kv_ways if lane.model.kv_slabs else 1
            cfg, kv_dim = local_kv(lane.model.cfg, ways)
            self.view = DenseView(mesh, batch, data_shards, ways, kv_dim,
                                  kv_gather)
            model, rows = Model(cfg), self.view.hi - self.view.lo
        if caches is not None:      # a released state's slabs (off-mesh)
            self.caches = {**caches, "pos": torch.zeros_like(caches["pos"])}
        else:
            self.caches = stack_slot_caches(model, rows, slot_len,
                                            params.embed.device)
        if self.view is not None:
            self.caches[VIEW] = self.view
        self._pend_bs: List[int] = []
        self._pend_caches: List[Any] = []

    def admit(self, b: int, prompt, need_tokens: int) -> bool:
        c1 = self.lane.prefill(self.params, prompt, self.slot_len)
        self._pend_bs.append(b)
        self._pend_caches.append(c1)
        return True

    def begin(self, b: int, prompt, need_tokens: int) -> bool:
        return True     # dense slots are pre-reserved; nothing to stage

    def finalize(self, b: int, cache):
        self._pend_bs.append(b)
        self._pend_caches.append(cache)

    def detached_len(self, entry_count: int) -> int:
        return self.slot_len

    def flush(self):
        if not self._pend_bs:
            return
        bs, cs = self._pend_bs, self._pend_caches
        self._pend_bs, self._pend_caches = [], []
        v = self.view
        if v is not None:           # this rank's rows, its part of the K/V
            keep = [i for i, b in enumerate(bs) if v.mine(b)]
            bs, cs = [bs[i] - v.lo for i in keep], [v.own(cs[i]) for i in keep]
        if bs:                      # one scatter for the whole admission wave
            self.caches = write_slots(self.caches, bs, cs)

    def _bytes(self, whole: bool) -> int:
        """The state's device bytes: this rank's, or (``whole``) every
        rank's part of it."""
        n = 0
        for key, val in self.caches.items():
            if key == VIEW:
                continue
            b = sum(t.nbytes for t in tree_leaves(val))
            if whole and self.view is not None:
                b = b * self.view.batch // (self.view.hi - self.view.lo)
                if key in SLABS and self.view.kv_dim is not None:
                    b *= self.view.kv_ways
            n += b
        return n

    @property
    def capacity_bytes(self) -> int:
        return self._bytes(whole=True)

    def stats(self) -> dict:
        return {} if self.view is None else \
            {"kv_rank_bytes": self._bytes(whole=False)}


class RecurrentState(DenseKV):
    """Fixed-size recurrent state (ssm / xlstm / hybrid): stacked like the
    dense layout — recurrent state has no sequence axis to page, so slots
    are whole per-slot states.  A separate class so layout policy stays
    out of the scheduler.  A released state's buffers (``caches``) are
    reset in place to what ``init_cache`` gives: a recurrence has no
    ``pos`` mask to hide what the last occupant left."""

    layout = "recurrent"

    def __init__(self, lane: "Lane", params, batch: int, slot_len: int, *,
                 caches: Optional[dict] = None, **kw):
        super().__init__(lane, params, batch, slot_len, caches=caches, **kw)
        if caches is not None:
            copy_leaves(self.caches, stack_slot_caches(
                lane.model, batch, slot_len, params.embed.device))


class PagedKV(SequenceState):
    """Paged slot caches: one shared block pool + per-slot block tables.

    Host side this owns a ``BlockPool`` (block ids only) and mirrors each
    slot's real content length; device side the cache dict ``{k, v, table,
    pos}``.  Writes are batched: admissions/retirements land in ``flush``
    (block scatters + ONE table-row/pos scatter), per-tick growth in
    ``prepare_tick``.  Retired slots' rows point at the trap block.

    PREFIX SHARING: admission consults a host-side prefix-block index
    (chained per-block digests of the prompt entries -> live block ids);
    shared blocks are mapped by refcount bump, and the first divergent
    decode write into a shared partial block forks a private copy
    (``cow_split``).  SWAP: ``swap_out`` stages a slot's blocks to host
    memory and releases them; ``swap_in`` restores them bit-for-bit,
    re-sharing full prompt blocks still live in the index.

    SHARDED (``data_shards > 1``): a ``ShardedBlockPool`` gives each data
    shard a contiguous block range and its own trap; prefix sharing, CoW
    and the capacity checks are per shard.  ``kv_ways`` is the model-axis
    division of every block's bytes; the default pool keeps the unsharded
    default's per-device bytes, so capacity scales with ``kv_shards =
    data_shards * kv_ways``.  With a ``mesh`` the device cache is this
    rank's local view (``ShardView``); the byte stats stay global.
    """

    layout = "paged"

    def __init__(self, lane: "Lane", params, batch: int, slot_len: int,
                 block_size: int, num_blocks: Optional[int] = None, *,
                 data_shards: int = 1, kv_ways: int = 1, mesh=None,
                 kv_gather: bool = False, caches: Optional[dict] = None):
        self.lane = lane
        self.params = params
        self.block_size = block_size
        self.max_blocks = blocks_for(slot_len, block_size)
        self.data_shards = data_shards
        self.kv_ways = kv_ways
        if data_shards > 1 and batch % data_shards != 0:
            raise ValueError(f"batch {batch} does not divide into "
                             f"{data_shards} data shards")
        self._spb = batch // max(data_shards, 1)    # slots per shard
        if data_shards > 1:
            if num_blocks is None:
                per_shard = (batch * self.max_blocks + 1) * kv_ways
            else:                   # explicit num_blocks = TOTAL blocks
                per_shard = -(-num_blocks // data_shards)
            per_shard = max(per_shard, 2)
            num_blocks = data_shards * per_shard
            self.pool = ShardedBlockPool(data_shards, per_shard,
                                         block_size, self._shard_of)
        else:
            if num_blocks is None:  # worst-case-safe default: dense capacity
                num_blocks = (batch * self.max_blocks + 1) * kv_ways
            num_blocks = max(num_blocks, 2)
            self.pool = BlockPool(num_blocks, block_size)
        self.device = params.embed.device
        cfg = lane.model.cfg
        self.view = None
        if mesh is not None:
            cfg, kv_dim = local_kv(cfg, kv_ways)
            self.view = ShardView(mesh, batch, data_shards,
                                  num_blocks // data_shards, kv_ways, kv_dim,
                                  kv_gather)
        split = self.view is not None and self.view.sharded
        local_blocks = num_blocks // data_shards if split else num_blocks
        if caches is not None:      # a released state's pool (off-mesh):
            caches["table"].zero_()     # every row the trap block
            self.caches = {**caches, "pos": torch.zeros_like(caches["pos"])}
        else:
            self.caches = transformer.init_paged_cache(
                cfg, local_blocks, block_size, self._spb if split else batch,
                self.max_blocks, device=self.device)
        if self.view is not None:
            self.caches[VIEW] = self.view
        # global bytes per block (every shard's part of it)
        self._block_bytes = (self.caches["k"].nbytes + self.caches["v"].nbytes
                             ) * (kv_ways if mesh is not None else 1) \
            // local_blocks
        self._len = [0] * batch     # real cache entries written per slot
        self._commit = [0] * batch  # blocks reserved for future growth
        self._entries: List[Optional[np.ndarray]] = [None] * batch  # prompts
        self._stale: set = set()    # retired slots awaiting a trap row
        self._pend: List[Tuple[int, np.ndarray, int]] = []  # (b, row, pos)
        # prefix-block index: prompt-entry digest -> block ids holding them
        self._prefix_index: Dict[bytes, Tuple[int, ...]] = {}
        self._indexed: set = set()  # blocks referenced by any index entry
        # CoW reservations: shared tail block -> slots that reserved one
        # future fork block for it (their _commit carries the headroom)
        self._cow_rsv: Dict[int, List[int]] = {}
        self._prefix_hits = 0
        self._shared_blocks = 0
        self._cow_forks = 0
        self._swaps = 0
        # chunked prefills in flight: slot -> (entries, new blocks, shared)
        self._begun: Dict[int, Tuple[np.ndarray, List[int], int]] = {}

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.array(ids, np.int32), device=self.device)

    def _mine(self, b: int) -> bool:
        """Slot ``b``'s rows live on this rank (always, off-mesh)."""
        return self.view is None or self.view.mine(b)

    def _dev_ids(self, ids) -> torch.Tensor:
        """Global block ids as this rank's local pool indices."""
        if self.view is not None:
            ids = self.view.local_ids(ids)
        return self._ids(ids)

    def _dev_slot(self, b: int) -> int:
        return b if self.view is None else b - self.view.lo

    # ------------------------------------------------------------ shards
    def _shard_of(self, b: int) -> int:
        """Data shard owning slot ``b`` (contiguous slot groups; 0 when the
        pool is unsharded)."""
        return b // self._spb if self.data_shards > 1 else 0

    def _pkey(self, shard: int, key: bytes):
        """Prefix-index key: the digest alone on the single pool; scoped by
        shard on sharded pools — prefix sharing/CoW stay host-side
        PER-SHARD, a slot can only map blocks its own shard owns."""
        return key if self.data_shards <= 1 else (shard, key)

    def _commit_sum(self, b: int) -> int:
        """Outstanding growth reservations charged against slot ``b``'s
        shard (all slots on the single pool)."""
        if self.data_shards <= 1:
            return sum(self._commit)
        s = self._shard_of(b)
        return sum(self._commit[s * self._spb:(s + 1) * self._spb])

    # ------------------------------------------------------------ prefix
    def _prefix_keys(self, entries: np.ndarray) -> List[bytes]:
        """Chained per-block digests: ``key[j]`` identifies the prefix
        covering blocks 0..j, as ``blake2b(key[j-1] || block_j_bytes)``."""
        E, bs = entries.size, self.block_size
        keys, prev = [], b""
        for j in range(blocks_for(E, bs)):
            prev = hashlib.blake2b(
                prev + entries[j * bs:min((j + 1) * bs, E)].tobytes(),
                digest_size=16).digest()
            keys.append(prev)
        return keys

    def _lookup_prefix(self, entries: np.ndarray,
                       shard: int = 0) -> Tuple[int, List[int]]:
        """Longest indexed prefix of ``entries`` within ``shard``: (entries
        matched, ids)."""
        E, bs = entries.size, self.block_size
        keys = self._prefix_keys(entries)
        for j in range(len(keys) - 1, -1, -1):
            got = self._prefix_index.get(self._pkey(shard, keys[j]))
            if got is not None:
                return min((j + 1) * bs, E), list(got)
        return 0, []

    def _register(self, entries: np.ndarray, blocks: List[int],
                  shard: int = 0):
        """Index every block-aligned prefix of ``entries`` (plus the full
        partial-tail prefix).  First registrant wins."""
        for j, key in enumerate(self._prefix_keys(entries)):
            self._prefix_index.setdefault(self._pkey(shard, key),
                                          tuple(blocks[:j + 1]))
        self._indexed.update(blocks)

    def _reindex(self):
        self._indexed = {blk for v in self._prefix_index.values()
                         for blk in v}

    def _purge_blocks(self, dead):
        """Drop index entries backed by any block that died."""
        dd = set(dead) & self._indexed
        if dd:
            self._prefix_index = {k: v for k, v in self._prefix_index.items()
                                  if not dd.intersection(v)}
            self._reindex()

    def _purge_written(self, blk: int):
        """Drop index entries referencing ``blk`` (about to be written)."""
        if blk in self._indexed:
            self._prefix_index = {k: v for k, v in self._prefix_index.items()
                                  if blk not in v}
            self._reindex()

    def share_prefix(self, b: int, entries: np.ndarray,
                     _peek: Optional[Tuple[int, List[int]]] = None) -> int:
        """Map the longest indexed prefix of ``entries`` into slot ``b``
        (refcount bumps), registering a CoW reservation when the shared
        tail is partial.  Returns the cache entries covered."""
        m, shared = _peek if _peek is not None else \
            self._lookup_prefix(entries, self._shard_of(b))
        if shared:
            self.pool.share(b, shared)
            if m % self.block_size:
                self._cow_rsv.setdefault(shared[-1], []).append(b)
            self._prefix_hits += 1
            self._shared_blocks += len(shared)
        return m

    def _drop_cow_rsv(self, b: int) -> int:
        """Remove slot ``b``'s outstanding CoW reservations; returns how
        many were dropped."""
        n = 0
        for blk in list(self._cow_rsv):
            lst = self._cow_rsv[blk]
            while b in lst:
                lst.remove(b)
                n += 1
            if not lst:
                del self._cow_rsv[blk]
        return n

    def cow_split(self, b: int):
        """Make slot ``b``'s next decode-write target block private: fork
        the partial tail block if shared (drawing the fork from a sharer's
        reservation), else invalidate index entries over it.  Returns
        (src, dst, table_index) for the staged device copy, or None."""
        E, bs = self._len[b], self.block_size
        if E % bs == 0:
            return None             # next write opens a fresh block
        i0 = E // bs
        blk = self.pool.owned(b)[i0]
        if self.pool.refcount(blk) > 1:
            new = self.pool.fork(b, blk)
            rsv = self._cow_rsv.get(blk)
            if rsv:
                s = rsv.pop()
                self._commit[s] = max(self._commit[s] - 1, 0)
                if not rsv:
                    del self._cow_rsv[blk]
            self._cow_forks += 1
            return blk, new, i0
        self._purge_written(blk)
        return None

    # ------------------------------------------------------------ admit
    def admit(self, b: int, prompt, need_tokens: int) -> bool:
        """Allocate the prompt's blocks and stage the prefill (writing only
        the unshared tail); False when the pool cannot back the request.
        The WORST-CASE block need is reserved up front, blocks are
        allocated as decode reaches them."""
        prompt = np.asarray(prompt, np.int32)
        entries = prompt[:-1]
        got = self._reserve(b, entries, need_tokens)
        if got is None:
            return False
        ns, blocks = got
        c1 = None
        if blocks:
            nb = self.pool.blocks_for(entries.size)
            c1 = self.lane.prefill(self.params, prompt,
                                   nb * self.block_size)
        self._land(b, entries, blocks, ns, c1)
        return True

    def _reserve(self, b: int, entries: np.ndarray,
                 need_tokens: int) -> Optional[Tuple[int, List[int]]]:
        """Map the live shared prefix, allocate the prompt's own blocks,
        commit worst-case growth.  Returns (shared block count, new block
        ids), or None when the pool cannot back the request."""
        E = entries.size
        nb = self.pool.blocks_for(E)
        total = self.pool.blocks_for(need_tokens)
        m, shared = self._lookup_prefix(entries, self._shard_of(b))
        own_new = nb - len(shared)
        cow_extra = 1 if shared and (m % self.block_size) else 0
        if not self.pool.can_alloc(own_new + (total - nb) + cow_extra
                                   + self._commit_sum(b), owner=b):
            return None
        ns = 0
        if shared:
            self.share_prefix(b, entries, _peek=(m, shared))
            ns = len(shared)
        blocks = self.pool.alloc(b, own_new) if own_new else []
        self._commit[b] = (total - nb) + cow_extra
        return ns, blocks

    def _land(self, b: int, entries: np.ndarray, blocks: List[int],
              ns: int, c1) -> None:
        """Stage a fully prefilled prompt into slot ``b``'s table row and
        the prefix index (``c1``: its single-sequence cache, or None when
        every block was shared)."""
        E = entries.size
        if blocks and self._mine(b):
            nb = self.pool.blocks_for(E)
            kb, vb = prompt_cache_to_blocks(
                {"k": c1["k"][:, :, :nb * self.block_size],
                 "v": c1["v"][:, :, :nb * self.block_size]},
                self.block_size)
            if self.view is not None:
                kb, vb = self.view.kv_part(kb), self.view.kv_part(vb)
            write_pool_blocks(self.caches["k"], self.caches["v"],
                              self._dev_ids(blocks), kb[:, ns:], vb[:, ns:])
        mine = self.pool.owned(b)
        # pad = trap block (the slot's shard's trap on sharded pools)
        row = np.full((self.max_blocks,), self.pool.trap(b), np.int32)
        row[:len(mine)] = mine
        self._pend.append((b, row, E))
        self._len[b] = E
        self._entries[b] = entries
        self._stale.discard(b)
        self._register(entries, mine, self._shard_of(b))

    def begin(self, b: int, prompt, need_tokens: int) -> bool:
        """Reserve blocks for a chunked prefill; the slot's row stays a
        TRAP row and its prefix stays unindexed until ``finalize``."""
        entries = np.asarray(prompt, np.int32)[:-1]
        got = self._reserve(b, entries, need_tokens)
        if got is None:
            return False
        ns, blocks = got
        self._begun[b] = (entries, blocks, ns)
        return True

    def finalize(self, b: int, cache):
        entries, blocks, ns = self._begun.pop(b)
        self._land(b, entries, blocks, ns, cache)

    def detached_len(self, entry_count: int) -> int:
        return self.pool.blocks_for(entry_count) * self.block_size

    def share_hints(self, prompts: List[Any]) -> List[bool]:
        """A prompt prefers the monolithic path when its first-block
        prefix key is live in the index, or another prompt of the wave
        opens with the same block."""
        firsts: List[Optional[bytes]] = []
        for p in prompts:
            entries = np.asarray(p, np.int32)[:-1]
            if entries.size == 0:
                firsts.append(None)
                continue
            firsts.append(hashlib.blake2b(
                entries[:self.block_size].tobytes(),
                digest_size=16).digest())
        counts = Counter(k for k in firsts if k is not None)
        # slot (and so shard) assignment happens after the hint, so probe
        # every shard's index — a miss only costs a chunking opportunity
        shards = range(max(self.data_shards, 1))
        return [k is not None
                and (any(self._pkey(s, k) in self._prefix_index
                         for s in shards) or counts[k] > 1)
                for k in firsts]

    def fits_empty(self, need_tokens: int, prompt=None) -> bool:
        total = self.pool.blocks_for(need_tokens)
        if total <= self.pool.usable():
            return True
        if prompt is not None:      # admissible via currently-live sharing?
            entries = np.asarray(prompt, np.int32)[:-1]
            for s in range(max(self.data_shards, 1)):
                m, shared = self._lookup_prefix(entries, s)
                cow = 1 if shared and (m % self.block_size) else 0
                if total - len(shared) + cow <= self.pool.usable():
                    return True
        return False

    def swappable(self, b: int) -> bool:
        """A victim is only worth swapping if its restore is GUARANTEED:
        every logical block restored privately must fit the pool."""
        rsv = sum(b in lst for lst in self._cow_rsv.values())
        return (len(self.pool.owned(b)) + self._commit[b] - rsv
                <= self.pool.usable())

    def owned_blocks(self, b: int) -> int:
        return len(self.pool.owned(b))

    @hot_path
    def flush(self):
        if not (self._pend or self._stale):
            return
        idx, rows, poss = [], [], []
        for b, row, p in self._pend:
            idx.append(b)
            rows.append(row)
            poss.append(p)
        for b in self._stale:       # retired, not re-admitted: trap row
            idx.append(b)
            rows.append(np.full((self.max_blocks,), self.pool.trap(b),
                                np.int32))
            poss.append(0)
        self._pend, self._stale = [], set()
        if self.view is not None:   # this rank's slot rows, local ids
            keep = [i for i, b in enumerate(idx) if self.view.mine(b)]
            if not keep:
                return
            idx = [self._dev_slot(idx[i]) for i in keep]
            rows = [rows[i] - self.view.base for i in keep]
            poss = [poss[i] for i in keep]
        ii = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        self.caches["table"][ii] = torch.as_tensor(np.stack(rows),
                                                   device=self.device)
        pos = self.caches["pos"].clone()
        pos[ii] = self._ids(poss)
        self.caches = {**self.caches, "pos": pos}

    @hot_path
    def prepare_tick(self, occupied, steps_h, n: int):
        """Grow every occupied slot to cover this tick's REAL decode steps
        (``min(steps_left, n)``), drawing down its admission reservation;
        ``cow_split`` first forks any shared partial tail block the tick
        writes into (one batched device copy for the wave)."""
        upd_b, upd_i, upd_blk = [], [], []
        cow_src, cow_dst = [], []
        for b in occupied:
            steps = min(int(steps_h[b]), n)
            if steps <= 0:
                continue
            cow = self.cow_split(b)
            mine = self._mine(b)
            if cow is not None and mine:
                src, dst, i0 = cow
                cow_src.append(src)
                cow_dst.append(dst)
                upd_b.append(self._dev_slot(b))
                upd_i.append(i0)
                upd_blk.append(dst)
            target = self._len[b] + steps
            new = self.pool.grow_to(b, target)
            self._commit[b] = max(self._commit[b] - len(new), 0)
            base = len(self.pool.owned(b)) - len(new)
            for j, blk in enumerate(new if mine else ()):
                upd_b.append(self._dev_slot(b))
                upd_i.append(base + j)
                upd_blk.append(blk)
            self._len[b] = target
        if cow_src:
            copy_pool_blocks(self.caches["k"], self.caches["v"],
                             self._dev_ids(cow_src), self._dev_ids(cow_dst))
        if upd_b:
            self.caches["table"][self._ids(upd_b).long(),
                                 self._ids(upd_i).long()] = \
                self._dev_ids(upd_blk)

    def retire(self, b: int):
        self._drop_cow_rsv(b)
        self._purge_blocks(self.pool.free(b))
        self._len[b] = 0
        self._commit[b] = 0
        self._entries[b] = None
        self._stale.add(b)

    # ------------------------------------------------------------ swap
    def swap_out(self, b: int) -> dict:
        """Stage slot ``b``'s blocks to host memory and free them.  The
        handle is self-contained (content, entry count, outstanding
        reservation); unconsumed CoW reservations are shed."""
        ids = self.pool.owned(b)
        k, v = self._read_blocks(b, ids)
        commit = max(self._commit[b] - self._drop_cow_rsv(b), 0)
        handle = {"k": k.cpu(), "v": v.cpu(),
                  "len": self._len[b], "commit": commit,
                  "entries": self._entries[b]}
        self._purge_blocks(self.pool.free(b))
        self._len[b] = 0
        self._commit[b] = 0
        self._entries[b] = None
        self._stale.add(b)
        self._swaps += 1
        return handle

    def _read_blocks(self, b: int, ids: List[int]):
        """Slot ``b``'s blocks ``ids`` (this rank's part of their bytes).
        On a data-split pool only the owning shard holds them: the others
        contribute zeros to one sum over the data axes, so every rank ends
        with the handle (a restore may land on another shard)."""
        if self.view is None:
            return read_pool_blocks(self.caches["k"], self.caches["v"],
                                    self._ids(ids))
        if self.view.mine(b):
            k, v = read_pool_blocks(self.caches["k"], self.caches["v"],
                                    self._dev_ids(ids))
        else:
            shape = (self.caches["k"].shape[0], len(ids)) + \
                tuple(self.caches["k"].shape[2:])
            k = self.caches["k"].new_zeros(shape)
            v = self.caches["v"].new_zeros(shape)
        if self.view.sharded:
            kv = self.view.mesh.all_reduce(torch.stack([k, v]),
                                           runtime.data_axes())
            k, v = kv[0], kv[1]
        return k, v

    def swap_in(self, b: int, handle: dict) -> bool:
        """Restore a swapped-out slot into ``b``; False when the pool
        cannot back its blocks + outstanding reservation yet.  Full prompt
        blocks still live in the prefix index are re-shared."""
        nb = handle["k"].shape[1]
        entries = handle.get("entries")
        ns, shared = 0, []
        if entries is not None:
            m, cand = self._lookup_prefix(entries, self._shard_of(b))
            ns = min(m // self.block_size, nb)
            shared = cand[:ns]
        if not self.pool.can_alloc((nb - ns) + handle["commit"]
                                   + self._commit_sum(b), owner=b):
            return False
        if shared:
            self.pool.share(b, shared)
            self._prefix_hits += 1
            self._shared_blocks += ns
        blocks = self.pool.alloc(b, nb - ns) if nb > ns else []
        self._commit[b] = handle["commit"]
        if nb > ns and self._mine(b):
            write_pool_blocks(self.caches["k"], self.caches["v"],
                              self._dev_ids(blocks),
                              handle["k"][:, ns:].to(self.device),
                              handle["v"][:, ns:].to(self.device))
        mine = self.pool.owned(b)
        row = np.full((self.max_blocks,), self.pool.trap(b), np.int32)
        row[:nb] = mine
        self._pend.append((b, row, handle["len"]))
        self._len[b] = handle["len"]
        self._entries[b] = entries
        self._stale.discard(b)
        if entries is not None:
            # restored PROMPT blocks are index-worthy again; generated-token
            # blocks stay out of the index
            self._register(entries, mine[:blocks_for(entries.size,
                                                     self.block_size)],
                           self._shard_of(b))
        return True

    @property
    def peak_bytes(self) -> int:
        """High-water mark of LIVE block bytes (shared blocks count once)."""
        return self.pool.peak_used * self._block_bytes

    @property
    def capacity_bytes(self) -> int:
        """The whole pool's bytes (every rank's part, on a mesh)."""
        return self.pool.num_blocks * self._block_bytes

    def stats(self) -> dict:
        # usable capacity: pool minus trap(s) — per-shard traps on sharded
        # pools.  kv_shards is the total byte-division factor (data shards
        # x model-axis kv ways): the per-device footprint of this capacity
        # is capacity_bytes / kv_shards
        if self.data_shards > 1:
            cap = self.data_shards * (self.pool.per_shard - 1)
        else:
            cap = self.pool.num_blocks - 1
        return {"kv_blocks_peak": self.pool.peak_used,
                "kv_block_size": self.block_size,
                "kv_prefix_hits": self._prefix_hits,
                "kv_shared_blocks": self._shared_blocks,
                "kv_cow_forks": self._cow_forks,
                "kv_swaps": self._swaps,
                "kv_shards": self.data_shards * self.kv_ways,
                "kv_capacity_blocks": cap}


# ---------------------------------------------------------------- lane
class SparePool:
    """Released device buffers kept for reuse, by shape key: at most
    ``bound`` of them, the least recently given back dropped first, and
    with them every CUDA graph addressing them (``capture.evict``).

    ``take(key)`` hands out the spare of that key that was made first, so
    a repeated sequence of takes and gives gets the same buffers in the
    same places whatever order they came back in, and the graphs keyed on
    them replay; ``give`` files buffers back under their id."""

    def __init__(self, bound: int):
        self.bound = bound
        self._held: "OrderedDict[int, Tuple[tuple, Any]]" = OrderedDict()
        self._made = 0

    def __len__(self) -> int:
        return len(self._held)

    def take(self, key: tuple) -> Tuple[int, Optional[Any]]:
        """(id, buffers) of the first-made spare of ``key``; (a new id,
        None) when there is none."""
        ids = [i for i, (k, _) in self._held.items() if k == key]
        if not ids:
            self._made += 1
            return self._made - 1, None
        i = min(ids)
        return i, self._held.pop(i)[1]

    def give(self, key: tuple, i: int, bufs) -> None:
        self._held[i] = (key, bufs)
        while len(self._held) > self.bound:
            _, (_, old) = self._held.popitem(last=False)
            evict([t for t in tree_leaves(old) if isinstance(t, torch.Tensor)])


class Lane:
    """Batched machinery for ONE model in ONE layout: the decode step
    (``SpecOps.step``), a bucketed prefill, chunked prefill, the multi-step
    decode loop, and the ``make_state`` factory the scheduler calls instead
    of picking adapters itself.  ``attn_backend`` ("auto" | "kernel" |
    "plain") selects the kernels' or the plain attention on every path."""

    def __init__(self, model, estimator: str, temperature: float,
                 layout: str = "dense", block_size: int = 32,
                 attn_backend: str = "auto", mesh=None,
                 data_shards: int = 1, graphs: bool = True):
        if attn_backend not in ("auto", "kernel", "plain"):
            raise ValueError(f"unknown attn_backend {attn_backend!r}; "
                             "known: auto | kernel | plain")
        require_token_prompts(model.cfg, "Lane")
        self.model = model
        self.estimator = estimator
        self.temperature = temperature
        self.layout = layout
        self.block_size = block_size
        self.attn_backend = attn_backend
        self.mesh = mesh
        self.data_shards = data_shards if mesh is not None else 1
        # model-axis byte division of the paged pool (1 when this model's
        # kv-heads/head-dim don't divide — replication fallback)
        self.kv_ways = kv_shard_ways(mesh, model.cfg) if mesh is not None \
            else 1
        self.ops = SpecOps(model, layout, attn_backend)
        self._est = get_batched_estimator(estimator)
        self._dense_side: Optional["Lane"] = None
        # KV attention masks every key row past ``pos`` (score -1e30, weight
        # exactly 0), so a prefill PADDED to a pow2 bucket with ``pos``
        # pinned back is bit-identical to an exact-length one.  Recurrent
        # families advance their state through EVERY input token, pads
        # included, so they prefill and extend at exact length.
        self._bucket_prefill = layout != "recurrent"
        # the decode tick captured per (n_steps, topk, shapes, buffers), as
        # the JAX package jits it with static_argnames=("n_steps", "topk");
        # the prefill per (max_seq, token bucket) and the chunked prefill's
        # extend per (chunk bucket, detached cache), as it jits them
        self.graphs = graphs
        where = f"{model.cfg.name}, {layout}"
        self._chunk_graph = capture(
            self._chunk_body, static_argnames=("n_steps", "topk"),
            copy_argnames=("pos", "tok", "steps_left", "unc_sum", "stop"),
            name=f"Lane.chunk({where})")
        self._prefill_graph = capture(
            self._prefill_body, static_argnames=("max_seq",),
            copy_argnames=("tokens",), name=f"Lane.prefill({where})")
        self._extend_graph = capture(
            self._extend_body, copy_argnames=("tokens", "pos"),
            name=f"Lane.extend({where})")
        # device caches of released states, and chunked prefills' detached
        # caches, by shape, for make_state and advance_prefill
        self._spare = SparePool(MAX_SPARE_STATES)
        self._detached = SparePool(MAX_SPARE_DETACHED)

    def captured_functions(self) -> list:
        """This lane's captured functions (its dense side's too)."""
        fns = [self._chunk_graph, self._prefill_graph, self._extend_graph]
        if self._dense_side is not None:
            fns += self._dense_side.captured_functions()
        return fns

    @property
    def captures(self) -> int:
        """CUDA graphs this lane's tick, prefills and extends have captured
        (its dense side's included)."""
        return sum(c.captures for c in self.captured_functions())

    @property
    def capture_seconds(self) -> float:
        """Host seconds those captures took (warm-ups included)."""
        return sum(c.capture_seconds for c in self.captured_functions())

    @property
    def spare_states(self) -> int:
        """Released states held for reuse (at most ``MAX_SPARE_STATES``)."""
        return len(self._spare)

    @property
    def spare_detached(self) -> int:
        """Detached prefill caches held for reuse (at most
        ``MAX_SPARE_DETACHED``)."""
        return len(self._detached)

    def graph_rule(self, device=None) -> str:
        """How this lane's decode tick runs: "captured" (a CUDA graph per
        key, ``core/capture.py``; every layout, recurrent states written in
        place by ``SpecOps``), or eager and why — a mesh's collectives run
        over gloo, which a graph cannot capture, the switch is off, or the
        tensors lie on the CPU, which has no graphs."""
        if self.mesh is not None:
            return "eager (mesh)"
        if not self.graphs:
            return "eager (graphs=False)"
        if device is not None and torch.device(device).type != "cuda":
            return "eager (cpu: no graphs)"
        return "captured"

    def prefill_rule(self, device=None) -> str:
        """How this lane's prefills and chunked-prefill extends run: as its
        tick (``graph_rule``), except on a recurrent lane, which prefills
        at exact length eager.  One graph per prompt length would cost a
        warm-up run and a capture, more than the eager pass it replaces,
        for every length a drain brings, and a drain's lengths rarely
        repeat (the JAX package compiles one prefill per length)."""
        if self.mesh is None and self.graphs and not self._bucket_prefill:
            return "eager (recurrent prefill: exact length)"
        return self.graph_rule(device)

    def dense_side(self) -> "Lane":
        """This lane's model re-hosted on dense per-slot caches (made once).
        Tree/self speculation needs block-masked extends — a dense-layout
        feature — so escalation groups build their side states through
        here instead of the scheduler ever comparing ``.layout``.  Identity
        on lanes that are already dense."""
        if self.layout == "dense":
            return self
        if self._dense_side is None:
            self._dense_side = Lane(self.model, self.estimator,
                                    self.temperature, layout="dense",
                                    block_size=self.block_size,
                                    attn_backend=self.attn_backend,
                                    mesh=self.mesh,
                                    data_shards=self.data_shards,
                                    graphs=self.graphs)
        return self._dense_side

    def prefill(self, params, prompt, max_seq: int):
        """Prefill ``prompt[:-1]`` into a fresh cache padded to ``max_seq``
        and return the cache (admission reads no logits).  KV lanes pad
        the ENTRY COUNT to a pow2 bucket (capped at ``max_seq``) and pin
        ``pos`` back to the real length: masked keys weigh exactly zero
        (plain ``mha`` and the flash kernel alike), so this is
        bit-identical to an exact-length prefill.  Recurrent lanes prefill
        the exact length.

        Under ``prefill_rule() == "captured"`` the prefill runs as one CUDA
        graph per (``max_seq``, bucket, parameters); the tokens are copied
        in and the cache the graph builds is cloned out of it."""
        entries = np.asarray(prompt, np.int32)[:-1]
        E = entries.size
        Ep = min(pow2_steps(E, 1 << 30), max_seq) if self._bucket_prefill \
            else E
        if Ep > E:
            entries = np.concatenate([entries, np.zeros(Ep - E, np.int32)])
        run = self._prefill_graph if self.prefill_rule() == "captured" \
            else self._prefill_body
        cache = run(params, torch.as_tensor(entries[None],
                                             device=params.embed.device),
                    max_seq=max_seq)
        if Ep > E:
            cache = {**cache, "pos": torch.full_like(cache["pos"], E)}
        return cache

    def _prefill_body(self, params, tokens, max_seq: int):
        """A prompt's prefill into a fresh cache of ``max_seq`` entries
        (what the prefill's graphs capture)."""
        _, cache = self.model.prefill(params, {"tokens": tokens},
                                      max_seq=max_seq,
                                      attn_backend=self.attn_backend)
        return cache

    def _extend_body(self, params, tokens, pools, pos):
        """One chunk of a chunked prefill, written into the detached
        cache's own K/V (what the extend's graphs capture)."""
        _, cache = self.model.extend_step(params, tokens,
                                          {**pools, "pos": pos},
                                          attn_backend=self.attn_backend)
        return cache

    # ------------------------------------------------------------ chunked
    def start_prefill(self, params, prompt, max_seq: int, chunk: int) -> dict:
        """Open a CHUNKED prefill job: ``advance_prefill`` moves ``chunk``
        prompt entries per call into a DETACHED single-sequence cache, so
        a long prompt never stalls the in-flight decode batch.  Once its
        cache has landed (``SequenceState.finalize``, then ``flush``), the
        caller hands the job to ``end_prefill``."""
        entries = np.asarray(prompt, np.int32)[:-1]
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        return {"entries": entries, "done": 0, "cache": None,
                "max_seq": max_seq, "chunk": chunk}

    def advance_prefill(self, params, job: dict) -> bool:
        """Advance one chunk of a ``start_prefill`` job; True when every
        prompt entry is in the detached cache.  The final partial chunk
        pow2-pads with ``pos`` pinned back (bit-exact) on KV lanes and runs
        exact-length on recurrent lanes.

        The first chunk is a prefill (``prefill``'s graphs); off a mesh a
        KV lane then moves the cache into detached buffers of its own,
        reused across jobs by ``max_seq`` (``SparePool``), and every later
        chunk extends them in place, captured per (chunk bucket, buffers)
        under ``prefill_rule() == "captured"`` with the tokens and ``pos``
        copied in.  Stale entries past ``pos`` are masked, as in a reused
        state."""
        entries, done, C = job["entries"], job["done"], job["chunk"]
        take = min(C, entries.size - done)
        toks = entries[done:done + take]
        dev = params.embed.device
        captured = self.prefill_rule() == "captured"
        if job["cache"] is None:
            run = self._prefill_graph if captured else self._prefill_body
            cache = run(params, torch.as_tensor(toks[None], device=dev),
                        max_seq=job["max_seq"])
            if self._bucket_prefill and self.mesh is None:
                key = ("detached", job["max_seq"])
                i, bufs = self._detached.take(key)
                if bufs is None:
                    bufs = {k: v for k, v in cache.items() if k != "pos"}
                else:
                    copy_leaves(bufs, cache)
                job["buffers"] = (key, i, bufs)
                cache = {**bufs, "pos": cache["pos"]}
        else:
            Tp = min(pow2_steps(take, C), job["max_seq"] - done) \
                if self._bucket_prefill else take
            if Tp > take:
                toks = np.concatenate([toks, np.zeros(Tp - take, np.int32)])
            tokens = torch.as_tensor(toks[None], device=dev)
            if self._bucket_prefill:
                run = self._extend_graph if captured else self._extend_body
                cache = run(params, tokens,
                            {k: v for k, v in job["cache"].items()
                             if k != "pos"}, job["cache"]["pos"])
            else:
                _, cache = self.model.extend_step(
                    params, tokens, job["cache"],
                    attn_backend=self.attn_backend)
            if Tp > take:
                cache = {**cache,
                         "pos": torch.full_like(cache["pos"], done + take)}
        job["cache"] = cache
        job["done"] = done + take
        return job["done"] >= entries.size

    def end_prefill(self, job: dict) -> None:
        """Give a finished job's detached buffers back for the next job;
        call it once its cache has landed in the state's device tensors
        (``flush``): a later job's prefill writes them."""
        got = job.pop("buffers", None)
        job["cache"] = None
        if got is not None:
            self._detached.give(*got)

    @hot_path
    def chunk(self, params, caches, tok, steps_left, unc_sum, gen, stop,
              n_steps: int, topk: int = 0):
        """``n_steps`` decode steps over all slots.  Returns the advanced
        state plus per-step (token, active) tapes (n_steps, B) — all on the
        device; the caller pulls them in one batch.  A slot that emits
        ``stop`` (a () int32 tensor on the device; -1 = never) keeps the
        token but zeroes its budget.  ``topk > 0`` also returns each step's
        top-k logit values (f32) and vocab indices (int32), (n_steps, B,
        topk): teacher supervision for serve-time adaptation, pulled with
        the token tape in the SAME batched pull.  ``topk=0`` returns
        exactly the tuple it always has.

        Under ``graph_rule() == "captured"`` the steps run as one CUDA
        graph per (``n_steps``, ``topk``, shapes, buffers), captured on
        the first call of a key (``core/capture.py``); ``pos``, the tokens,
        budgets, summed uncertainty and ``stop`` are copied in."""
        pools = {k: v for k, v in caches.items() if k != "pos"}
        run = self._chunk_graph if self.graph_rule() == "captured" \
            else self._chunk_body
        return run(params, pools, caches["pos"], tok, steps_left, unc_sum,
                   stop, gen, n_steps=n_steps, topk=topk)

    def _chunk_body(self, params, pools, pos, tok, steps_left, unc_sum, stop,
                    gen, n_steps: int, topk: int):
        """The steps of ``chunk`` (what its graphs capture)."""
        caches = {**pools, "pos": pos}
        view = caches.get(VIEW)
        B = tok.shape[0]
        if view is not None and view.sharded:   # this rank's slots
            tok, steps_left, unc_sum = (view.rows(tok), view.rows(steps_left),
                                        view.rows(unc_sum))
        toks, actives, tvals, tidx = [], [], [], []
        for _ in range(n_steps):
            lg, caches = self.ops.step(params, tok, caches)       # (B, V)
            active = steps_left > 0
            nxt = next_tokens(lg, self.temperature, gen, view)
            unc_sum = unc_sum + torch.where(active, self._est(lg), 0.0)
            steps_left = torch.where(active & (nxt == stop), 0,
                                     steps_left - active.to(torch.int32))
            toks.append(nxt)
            actives.append(active)
            if topk:
                tv, ti = torch.topk(lg.float(), topk, dim=-1)
                tvals.append(tv)
                tidx.append(ti.to(torch.int32))
            tok = nxt[:, None, None]
        tapes = [torch.stack(toks), torch.stack(actives)]
        if topk:
            tapes += [torch.stack(tvals), torch.stack(tidx)]
        if view is not None and view.sharded:
            # the tick's ONE collective: every rank gets the whole batch's
            # state and tapes (slot axis first for the gather, then back)
            got = runtime.gather_wave(tok, steps_left, unc_sum,
                                      *(t.transpose(0, 1) for t in tapes),
                                      rows=B)
            tok, steps_left, unc_sum = got[:3]
            tapes = [t.transpose(0, 1) for t in got[3:]]
        return (caches, tok, steps_left, unc_sum) + tuple(tapes)

    def make_state(self, params, batch: int, slot_len: int, *,
                   need_tokens: Optional[Sequence[int]] = None,
                   num_blocks: Optional[int] = None) -> SequenceState:
        """Build this lane's decode-state adapter.  ``need_tokens``
        (escalation groups) sizes a paged pool to the group's residency,
        pow2-bucketed.  On a mesh every layout is built as this rank's
        local view (``_place``).

        A state of a shape that ``release`` gave back takes that state's
        device buffers: fresh host bookkeeping (allocator, prefix index),
        the table reset to the trap block and ``pos`` to 0; the stale K/V
        past ``pos`` is masked, as it is in a live state, and a recurrent
        state's leaves are reset to ``init_cache``'s.  The tick's and
        round's CUDA graphs are tied to buffer addresses
        (``core/capture.py``), so a drain of a shape seen before captures
        nothing new.  The lane keeps at most ``MAX_SPARE_STATES`` released
        states (``SparePool``)."""
        shards = self.data_shards if batch % max(self.data_shards, 1) == 0 \
            else 1
        if self.layout != "paged":
            cls = RecurrentState if self.layout == "recurrent" else DenseKV
            key = (cls.layout, batch, slot_len)
            i, bufs = self._spare.take(key)
            st = cls(self, params, batch, slot_len, data_shards=shards,
                     caches=bufs, **self._place(params))
            st.reuse_key, st.reuse_id = key, i
            return st
        if num_blocks is None and need_tokens is not None:
            if shards > 1:
                # per-shard demand: slot i lives on shard i // (batch/S), so
                # size every shard's range to the HEAVIEST shard (pools are
                # uniform), pow2-bucketed
                spb = batch // shards
                per = [0] * shards
                for i, t in enumerate(need_tokens):
                    per[i // spb] += blocks_for(t, self.block_size)
                num_blocks = shards * (1 + pow2_steps(max(per), 1 << 30))
            else:
                needed = sum(blocks_for(t, self.block_size)
                             for t in need_tokens)
                num_blocks = 1 + pow2_steps(needed, 1 << 30)
        key = ("paged", batch, slot_len, num_blocks)
        i, bufs = self._spare.take(key)
        st = PagedKV(self, params, batch, slot_len, self.block_size,
                     num_blocks, data_shards=shards, kv_ways=self.kv_ways,
                     caches=bufs, **self._place(params))
        st.reuse_key, st.reuse_id = key, i
        return st

    def release(self, state: SequenceState) -> None:
        """Give ``state``'s device buffers back to ``make_state`` for the
        next state of its shape (recurrent states are reset to
        ``init_cache``'s values there); the state must not be used after.
        Past ``MAX_SPARE_STATES`` the least recently released state is
        dropped with every graph keyed on its buffers.  A no-op on a mesh,
        whose ticks run eager by rule: its states stay fresh."""
        if self.mesh is None:
            self._spare.give(state.reuse_key, state.reuse_id, state.caches)

    def _place(self, params) -> dict:
        """Where a fresh state's device arrays live (nothing off-mesh):
        this rank's local view — slots (the paged pool's block dim) over
        the data axes, K/V kv-heads (else the head dim) over 'model', as
        ``launch/sharding.cache_spec`` and ``paged_cache_spec`` place
        them.  ``kv_gather``: this lane's attention is not tensor parallel
        over the K/V heads (replicated params, or the head-count
        fallback), so its steps gather full-width K/V (``ShardView.run``,
        ``DenseView.run``)."""
        if self.mesh is None:
            return {}
        tp = getattr(params, "tp", None)
        tp_heads = tp is not None and \
            tp.cfg.num_kv_heads != tp.full_cfg.num_kv_heads
        return {"mesh": self.mesh, "kv_gather": not tp_heads}
