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
    dispatch lives here.

Cache trees: every leaf has the slot axis first, except the attention
slabs ``k`` / ``v`` (a leading layer or group axis, then the slot axis).
Device tensors are updated IN PLACE where JAX returns new arrays (pools,
tables, dense and hybrid K/V slabs, slot writes at admission); the
recurrent models' steps return new state tensors, and ``pos`` is always
replaced by a new tensor, so a snapshot never aliases live state except
through the slabs, which the recurrent snapshot copies.  The sharded pools
are a later slice of the port.
"""
from __future__ import annotations

import hashlib
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import hot_path
from repro_torch.core.paged_cache import (BlockPool, blocks_for,
                                          copy_pool_blocks,
                                          prompt_cache_to_blocks,
                                          read_pool_blocks, write_pool_blocks)
from repro_torch.core.uncertainty import get_batched_estimator
from repro_torch.models.model import require_token_prompts
from repro_torch.models.ssm import tree_leaves, tree_map

# cache entries holding attention slabs (slot axis second, written in place)
SLABS = ("k", "v")


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


def next_tokens(logits, temperature: float, gen):
    """Greedy argmax at T=0, else a categorical draw (Gumbel-max with
    uniforms from ``gen``).  Returns (B,) int32."""
    if temperature == 0.0:
        return logits.argmax(-1).to(torch.int32)
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
        if key != "pos":
            tree_map(put(1 if key in SLABS else 0), big,
                     *(c[key] for c in caches))
    pos = slots["pos"].clone()
    pos[idx] = torch.stack([c["pos"] for c in caches]).to(torch.int32)
    return {**slots, "pos": pos}


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

    def step(self, params, tok, caches):
        """tok (G, 1, 1) -> (logits (G, V), caches)."""
        if self.layout == "paged":
            return self.model.paged_decode_step(
                params, tok[:, :, 0], caches, attn_backend=self.attn_backend)
        return self.model.decode_step(params, tok[:, :, 0], caches,
                                      attn_backend=self.attn_backend)

    def extend(self, params, tokens, caches):
        """tokens (G, T) -> (logits (G, T, V), caches)."""
        if self.layout == "paged":
            return self.model.paged_extend_step(params, tokens, caches)
        return self.model.extend_step(params, tokens, caches,
                                      attn_backend=self.attn_backend)

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
        q_pos = caches["pos"].long()[:, None] + depths.long()[None, :]
        return self.model.extend_step(params, tokens, caches,
                                      block_mask=block_mask,
                                      q_positions=q_pos,
                                      attn_backend=self.attn_backend)

    def reset(self, caches, snap):
        """Roll the group back to the pre-round snapshot WITHOUT committing
        anything (the self lane re-anchors before its verify)."""
        if self.layout == "recurrent":
            return snap
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
        mutated later); the cache tree itself for recurrent state, whose
        steps return new tensors — with copies of the attention slabs
        (hybrid), which the round's steps write in place."""
        if self.layout == "recurrent":
            return {k: v.clone() if k in SLABS else v
                    for k, v in caches.items()}
        return caches["pos"]

    def commit(self, params, caches, snap, tokens, counts):
        """Rewind the post-round ``caches`` to each slot's accepted prefix:
        ``tokens`` (G, T) is the round's draft tape [pending, d_0..], and
        ``counts`` (G,) int32 (0 freezes a slot on its snapshot) how many
        of its entries each slot commits.  KV: one ``pos`` write (rejected
        entries stay, masked and overwritten).  Recurrent: the batched
        ``replay_step`` from the snapshot — each slot re-advances through
        its own prefix."""
        if self.layout == "recurrent":
            return self.model.replay_step(params, tokens, snap, counts,
                                          attn_backend=self.attn_backend)
        return {**caches, "pos": (snap + counts).to(torch.int32)}


# ---------------------------------------------------------------- states
class SequenceState:
    """Adapter protocol for the scheduler's per-slot decode state.
    ``caches`` is the device dict the lane's step functions consume;
    everything else is host bookkeeping."""

    layout = "dense"
    caches: Any

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
    ``slot_len`` (kept as the parity oracle)."""

    layout = "dense"

    def __init__(self, lane: "Lane", params, batch: int, slot_len: int):
        self.lane = lane
        self.params = params
        self.slot_len = slot_len
        self.caches = stack_slot_caches(lane.model, batch, slot_len,
                                        params.embed.device)
        self._pend_bs: List[int] = []
        self._pend_caches: List[Any] = []

    def admit(self, b: int, prompt, need_tokens: int) -> bool:
        _, c1 = self.lane.prefill(self.params, prompt, self.slot_len)
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
        if self._pend_bs:   # one scatter for the whole admission wave
            self.caches = write_slots(self.caches, self._pend_bs,
                                      self._pend_caches)
            self._pend_bs, self._pend_caches = [], []


class RecurrentState(DenseKV):
    """Fixed-size recurrent state (ssm / xlstm / hybrid): stacked like the
    dense layout — recurrent state has no sequence axis to page, so slots
    are whole per-slot states.  A separate class so layout policy stays
    out of the scheduler."""

    layout = "recurrent"


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
    """

    layout = "paged"

    def __init__(self, lane: "Lane", params, batch: int, slot_len: int,
                 block_size: int, num_blocks: Optional[int] = None):
        self.lane = lane
        self.params = params
        self.block_size = block_size
        self.max_blocks = blocks_for(slot_len, block_size)
        if num_blocks is None:  # worst-case-safe default: dense capacity
            num_blocks = batch * self.max_blocks + 1
        num_blocks = max(num_blocks, 2)
        self.pool = BlockPool(num_blocks, block_size)
        self.device = params.embed.device
        self.caches = lane.model.init_paged_cache(
            num_blocks, block_size, batch, self.max_blocks,
            device=self.device)
        self._block_bytes = (self.caches["k"].nbytes +
                             self.caches["v"].nbytes) // num_blocks
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

    def _lookup_prefix(self, entries: np.ndarray) -> Tuple[int, List[int]]:
        """Longest indexed prefix of ``entries``: (entries matched, ids)."""
        E, bs = entries.size, self.block_size
        keys = self._prefix_keys(entries)
        for j in range(len(keys) - 1, -1, -1):
            got = self._prefix_index.get(keys[j])
            if got is not None:
                return min((j + 1) * bs, E), list(got)
        return 0, []

    def _register(self, entries: np.ndarray, blocks: List[int]):
        """Index every block-aligned prefix of ``entries`` (plus the full
        partial-tail prefix).  First registrant wins."""
        for j, key in enumerate(self._prefix_keys(entries)):
            self._prefix_index.setdefault(key, tuple(blocks[:j + 1]))
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
            self._lookup_prefix(entries)
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
            _, c1 = self.lane.prefill(self.params, prompt,
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
        m, shared = self._lookup_prefix(entries)
        own_new = nb - len(shared)
        cow_extra = 1 if shared and (m % self.block_size) else 0
        if not self.pool.can_alloc(own_new + (total - nb) + cow_extra
                                   + sum(self._commit)):
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
        if blocks:
            nb = self.pool.blocks_for(E)
            kb, vb = prompt_cache_to_blocks(
                {"k": c1["k"][:, :, :nb * self.block_size],
                 "v": c1["v"][:, :, :nb * self.block_size]},
                self.block_size)
            write_pool_blocks(self.caches["k"], self.caches["v"],
                              self._ids(blocks), kb[:, ns:], vb[:, ns:])
        mine = self.pool.owned(b)
        row = np.full((self.max_blocks,), self.pool.trap(b), np.int32)
        row[:len(mine)] = mine
        self._pend.append((b, row, E))
        self._len[b] = E
        self._entries[b] = entries
        self._stale.discard(b)
        self._register(entries, mine)

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
        return [k is not None
                and (k in self._prefix_index or counts[k] > 1)
                for k in firsts]

    def fits_empty(self, need_tokens: int, prompt=None) -> bool:
        total = self.pool.blocks_for(need_tokens)
        if total <= self.pool.usable():
            return True
        if prompt is not None:      # admissible via currently-live sharing?
            entries = np.asarray(prompt, np.int32)[:-1]
            m, shared = self._lookup_prefix(entries)
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
        ii = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        self.caches["table"][ii] = torch.as_tensor(np.stack(rows),
                                                   device=self.device)
        pos = self.caches["pos"].clone()
        pos[ii] = self._ids(poss)
        self.caches = {**self.caches, "pos": pos}
        self._pend, self._stale = [], set()

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
            if cow is not None:
                src, dst, i0 = cow
                cow_src.append(src)
                cow_dst.append(dst)
                upd_b.append(b)
                upd_i.append(i0)
                upd_blk.append(dst)
            target = self._len[b] + steps
            new = self.pool.grow_to(b, target)
            self._commit[b] = max(self._commit[b] - len(new), 0)
            base = len(self.pool.owned(b)) - len(new)
            for j, blk in enumerate(new):
                upd_b.append(b)
                upd_i.append(base + j)
                upd_blk.append(blk)
            self._len[b] = target
        if cow_src:
            copy_pool_blocks(self.caches["k"], self.caches["v"],
                             self._ids(cow_src), self._ids(cow_dst))
        if upd_b:
            self.caches["table"][self._ids(upd_b).long(),
                                 self._ids(upd_i).long()] = self._ids(upd_blk)

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
        k, v = read_pool_blocks(self.caches["k"], self.caches["v"],
                                self._ids(ids))
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

    def swap_in(self, b: int, handle: dict) -> bool:
        """Restore a swapped-out slot into ``b``; False when the pool
        cannot back its blocks + outstanding reservation yet.  Full prompt
        blocks still live in the prefix index are re-shared."""
        nb = handle["k"].shape[1]
        entries = handle.get("entries")
        ns, shared = 0, []
        if entries is not None:
            m, cand = self._lookup_prefix(entries)
            ns = min(m // self.block_size, nb)
            shared = cand[:ns]
        if not self.pool.can_alloc((nb - ns) + handle["commit"]
                                   + sum(self._commit)):
            return False
        if shared:
            self.pool.share(b, shared)
            self._prefix_hits += 1
            self._shared_blocks += ns
        blocks = self.pool.alloc(b, nb - ns) if nb > ns else []
        self._commit[b] = handle["commit"]
        if nb > ns:
            write_pool_blocks(self.caches["k"], self.caches["v"],
                              self._ids(blocks),
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
                                                     self.block_size)])
        return True

    @property
    def peak_bytes(self) -> int:
        """High-water mark of LIVE block bytes (shared blocks count once)."""
        return self.pool.peak_used * self._block_bytes

    @property
    def capacity_bytes(self) -> int:
        return self.caches["k"].nbytes + self.caches["v"].nbytes

    def stats(self) -> dict:
        return {"kv_blocks_peak": self.pool.peak_used,
                "kv_block_size": self.block_size,
                "kv_prefix_hits": self._prefix_hits,
                "kv_shared_blocks": self._shared_blocks,
                "kv_cow_forks": self._cow_forks,
                "kv_swaps": self._swaps,
                "kv_shards": 1,
                "kv_capacity_blocks": self.pool.num_blocks - 1}


# ---------------------------------------------------------------- lane
class Lane:
    """Batched machinery for ONE model in ONE layout: the decode step
    (``SpecOps.step``), a bucketed prefill, chunked prefill, the multi-step
    decode loop, and the ``make_state`` factory the scheduler calls instead
    of picking adapters itself.  ``attn_backend`` ("auto" | "kernel" |
    "plain") selects the kernels' or the plain attention on every path."""

    def __init__(self, model, estimator: str, temperature: float,
                 layout: str = "dense", block_size: int = 32,
                 attn_backend: str = "auto"):
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
        self.ops = SpecOps(model, layout, attn_backend)
        self._est = get_batched_estimator(estimator)
        self._dense_side: Optional["Lane"] = None
        # KV attention masks every key row past ``pos`` (score -1e30, weight
        # exactly 0), so a prefill PADDED to a pow2 bucket with ``pos``
        # pinned back is bit-identical to an exact-length one.  Recurrent
        # families advance their state through EVERY input token, pads
        # included, so they prefill and extend at exact length.
        self._bucket_prefill = layout != "recurrent"

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
                                    attn_backend=self.attn_backend)
        return self._dense_side

    def prefill(self, params, prompt, max_seq: int):
        """Prefill ``prompt[:-1]`` into a fresh cache padded to ``max_seq``.
        KV lanes pad the ENTRY COUNT to a pow2 bucket (capped at
        ``max_seq``) and pin ``pos`` back to the real length: masked keys
        weigh exactly zero (plain ``mha`` and the flash kernel alike), so
        this is bit-identical to an exact-length prefill.  Recurrent lanes
        prefill the exact length."""
        entries = np.asarray(prompt, np.int32)[:-1]
        E = entries.size
        Ep = min(pow2_steps(E, 1 << 30), max_seq) if self._bucket_prefill \
            else E
        if Ep > E:
            entries = np.concatenate([entries, np.zeros(Ep - E, np.int32)])
        dev = params.embed.device
        lg, cache = self.model.prefill(
            params, {"tokens": torch.as_tensor(entries[None], device=dev)},
            max_seq=max_seq, attn_backend=self.attn_backend)
        if Ep > E:
            cache = {**cache, "pos": torch.full_like(cache["pos"], E)}
        return lg, cache

    # ------------------------------------------------------------ chunked
    def start_prefill(self, params, prompt, max_seq: int, chunk: int) -> dict:
        """Open a CHUNKED prefill job: ``advance_prefill`` moves ``chunk``
        prompt entries per call into a DETACHED single-sequence cache, so
        a long prompt never stalls the in-flight decode batch."""
        entries = np.asarray(prompt, np.int32)[:-1]
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        return {"entries": entries, "done": 0, "cache": None,
                "max_seq": max_seq, "chunk": chunk}

    def advance_prefill(self, params, job: dict) -> bool:
        """Advance one chunk of a ``start_prefill`` job; True when every
        prompt entry is in the detached cache.  The final partial chunk
        pow2-pads with ``pos`` pinned back (bit-exact) on KV lanes and runs
        exact-length on recurrent lanes."""
        entries, done, C = job["entries"], job["done"], job["chunk"]
        take = min(C, entries.size - done)
        toks = entries[done:done + take]
        dev = params.embed.device
        if job["cache"] is None:
            _, cache = self.model.prefill(
                params, {"tokens": torch.as_tensor(toks[None], device=dev)},
                max_seq=job["max_seq"], attn_backend=self.attn_backend)
        else:
            Tp = min(pow2_steps(take, C), job["max_seq"] - done) \
                if self._bucket_prefill else take
            if Tp > take:
                toks = np.concatenate([toks, np.zeros(Tp - take, np.int32)])
            _, cache = self.model.extend_step(
                params, torch.as_tensor(toks[None], device=dev),
                job["cache"], attn_backend=self.attn_backend)
            if Tp > take:
                cache = {**cache,
                         "pos": torch.full_like(cache["pos"], done + take)}
        job["cache"] = cache
        job["done"] = done + take
        return job["done"] >= entries.size

    @hot_path
    def chunk(self, params, caches, tok, steps_left, unc_sum, gen,
              stop: int, n_steps: int, topk: int = 0):
        """``n_steps`` decode steps over all slots.  Returns the advanced
        state plus per-step (token, active) tapes (n_steps, B) — all on the
        device; the caller pulls them in one batch.  A slot that emits
        ``stop`` (-1 = never) keeps the token but zeroes its budget.
        ``topk > 0`` also returns each step's top-k logit values (f32) and
        vocab indices (int32), (n_steps, B, topk): teacher supervision for
        serve-time adaptation, pulled with the token tape in the SAME
        batched pull.  ``topk=0`` returns exactly the tuple it always
        has."""
        toks, actives, tvals, tidx = [], [], [], []
        for _ in range(n_steps):
            lg, caches = self.ops.step(params, tok, caches)       # (B, V)
            active = steps_left > 0
            nxt = next_tokens(lg, self.temperature, gen)
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
        out = (caches, tok, steps_left, unc_sum, torch.stack(toks),
               torch.stack(actives))
        if topk:
            out += (torch.stack(tvals), torch.stack(tidx))
        return out

    def make_state(self, params, batch: int, slot_len: int, *,
                   need_tokens: Optional[Sequence[int]] = None,
                   num_blocks: Optional[int] = None) -> SequenceState:
        """Build this lane's decode-state adapter.  ``need_tokens``
        (escalation groups) sizes a paged pool to the group's residency,
        pow2-bucketed."""
        if self.layout == "recurrent":
            return RecurrentState(self, params, batch, slot_len)
        if self.layout == "dense":
            return DenseKV(self, params, batch, slot_len)
        if num_blocks is None and need_tokens is not None:
            needed = sum(blocks_for(t, self.block_size) for t in need_tokens)
            num_blocks = 1 + pow2_steps(needed, 1 << 30)
        return PagedKV(self, params, batch, slot_len, self.block_size,
                       num_blocks)
