"""Paged (block) KV-cache allocation for the serving scheduler.

The dense scheduler pads every slot's KV cache to a common ``slot_len``, so
one long-prompt outlier inflates every slot (ROADMAP "Paged KV" gap).  This
module is the memory half of the fix — the vLLM-style block pool:

  * the device cache is ONE pool of ``num_blocks`` fixed-size token blocks
    per layer (``models/transformer.init_paged_cache``), shared by all
    slots;
  * each slot owns a list of block ids; the device sees them as a padded
    int32 BLOCK TABLE row ``(max_blocks,)`` — logical position ``p`` of
    slot ``b`` lives in block ``table[b, p // block_size]`` at offset
    ``p % block_size``;
  * blocks are allocated at admission (prompt prefill), GROWN on demand at
    decode time (one tick's worth at a time), and freed at retirement —
    per-slot capacity is decoupled from the batch's worst request.

Blocks are REFCOUNTED: slots whose prompts share a block-aligned prefix map
the shared prefix onto the same physical blocks (``share``), and the first
divergent write forks a private copy (``fork`` — copy-on-write).  ``used``
counts physical blocks, so sharing shows up directly in ``peak_used`` and
the benchmark's kv_savings number.

Block 0 is the TRAP block: it is never allocated, and every unused table
entry points at it.  Retired slots keep garbage-decoding behind the
scheduler's ``active`` mask until re-admission; redirecting their table
rows to the trap confines those masked writes so freed blocks can be
reallocated immediately without corruption.

``BlockPool`` is the host-side allocator (pure Python bookkeeping — block
ids only, no device arrays), a copy of the JAX package's; ``write_pool_blocks``
/ ``copy_pool_blocks`` are the in-place torch scatters that land a prefilled
prompt's K/V blocks in the pool and execute copy-on-write forks.
``ShardedBlockPool`` waits for the sharded-serving slice.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List

TRAP_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` cache entries (0 tokens -> 0)."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // block_size)


class BlockPool:
    """Host-side fixed-size block allocator over a device KV pool.

    Tracks only block IDS — the device arrays live in the scheduler's
    cache pytree.  Block 0 (``TRAP_BLOCK``) is reserved and never handed
    out.  ``peak_used`` is the high-water mark of live PHYSICAL blocks
    (a block shared by k owners counts once), which the benchmark converts
    to peak cache bytes.

    The free list is a min-heap, so the lowest free ids are handed out
    first no matter how allocations and frees interleave — deterministic
    block layouts in tests survive retire/admit churn.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the trap), got "
                             f"{num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # min-heap: low ids handed out first (deterministic layouts)
        self._free: List[int] = list(range(1, num_blocks))
        heapq.heapify(self._free)
        self._owned: Dict[Any, List[int]] = {}
        self._refs: Dict[int, int] = {}
        self.peak_used = 0

    # ------------------------------------------------------------ queries
    @property
    def used(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def can_alloc(self, n_blocks: int, owner=None) -> bool:
        """``owner`` narrows the check to that owner's shard on sharded
        pools; the single pool ignores it."""
        return len(self._free) >= n_blocks

    def usable(self) -> int:
        """Blocks an owner could ever hold (pool minus trap); on sharded
        pools this is the PER-SHARD bound — one owner never spans shards."""
        return self.num_blocks - 1

    def trap(self, owner) -> int:
        """Trap block id for ``owner``'s table-row padding (per-shard on
        sharded pools, so masked garbage writes stay shard-local)."""
        return TRAP_BLOCK

    def owned(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    def refcount(self, blk: int) -> int:
        return self._refs.get(blk, 0)

    # ------------------------------------------------------------ alloc
    def alloc(self, owner, n_blocks: int) -> List[int]:
        """Take ``n_blocks`` for ``owner``; raises when the pool is
        exhausted (the scheduler checks ``can_alloc`` first and defers or
        preempts instead)."""
        if n_blocks > len(self._free):
            raise RuntimeError(
                f"KV block pool exhausted: want {n_blocks}, have "
                f"{len(self._free)} free of {self.num_blocks - 1} "
                f"(raise --kv-blocks or shrink the batch)")
        got = [heapq.heappop(self._free) for _ in range(n_blocks)]
        for blk in got:
            self._refs[blk] = 1
        self._owned.setdefault(owner, []).extend(got)
        self.peak_used = max(self.peak_used, self.used)
        return got

    def grow_to(self, owner, n_tokens: int) -> List[int]:
        """Extend ``owner`` so its blocks cover ``n_tokens`` cache entries;
        returns only the NEW block ids (possibly empty)."""
        have = len(self._owned.get(owner, ()))
        need = self.blocks_for(n_tokens) - have
        if need <= 0:
            return []
        return self.alloc(owner, need)

    # ------------------------------------------------------------ sharing
    def share(self, owner, blocks: List[int]) -> None:
        """Map ``blocks`` (another owner's live prefix) into ``owner``'s
        logical block list, bumping each refcount — no physical
        allocation.  ``owner``'s list must currently be empty or end
        exactly where ``blocks`` continue (prefixes are shared front-first
        at admission)."""
        for blk in blocks:
            if self._refs.get(blk, 0) < 1:
                raise RuntimeError(f"cannot share dead block {blk}")
            self._refs[blk] += 1
        self._owned.setdefault(owner, []).extend(blocks)

    def fork(self, owner, blk: int) -> int:
        """Copy-on-write split: give ``owner`` a fresh private block in
        place of shared ``blk`` (the caller copies the device contents).
        Returns the new block id; ``blk`` keeps its remaining owners."""
        mine = self._owned.get(owner, [])
        i = mine.index(blk)          # raises if owner doesn't hold blk
        if self._refs.get(blk, 0) <= 1:
            return blk               # already private: nothing to split
        [new] = self.alloc(owner, 1)
        self._owned[owner].pop()     # alloc appended; splice in place
        mine[i] = new
        self._deref(blk)
        return new

    # ------------------------------------------------------------ free
    def _deref(self, blk: int) -> bool:
        """Drop one reference; True if the block died (returned to the
        free heap)."""
        self._refs[blk] -= 1
        if self._refs[blk] > 0:
            return False
        del self._refs[blk]
        heapq.heappush(self._free, blk)
        return True

    def free(self, owner) -> List[int]:
        """Release all of ``owner``'s references (idempotent).  Returns
        the ids that actually DIED (refcount hit zero) so callers can
        invalidate host-side indexes over their contents."""
        dead = []
        for blk in self._owned.pop(owner, ()):
            if self._deref(blk):
                dead.append(blk)
        return dead


# ---------------------------------------------------------------- device
def write_pool_blocks(k_pool, v_pool, block_ids, k_blocks, v_blocks):
    """Scatter one prompt's prefilled K/V into its allocated pool blocks,
    IN PLACE (the JAX twin returns new pools; here the pools are the
    scheduler's live device tensors and are returned for symmetry).

    k_pool/v_pool: (L, NB, bs, Kv, hd); block_ids: (nb,) int32;
    k_blocks/v_blocks: (L, nb, bs, Kv, hd).
    """
    idx = block_ids.long()
    k_pool[:, idx] = k_blocks.to(k_pool.dtype)
    v_pool[:, idx] = v_blocks.to(v_pool.dtype)
    return k_pool, v_pool


def copy_pool_blocks(k_pool, v_pool, src_ids, dst_ids):
    """Copy-on-write fork: duplicate blocks ``src_ids`` into ``dst_ids``
    (both (n,) int32), in place.  The advanced-index read copies first, so
    overlapping src/dst sets still see the pre-fork contents."""
    s, d = src_ids.long(), dst_ids.long()
    k_pool[:, d] = k_pool[:, s]
    v_pool[:, d] = v_pool[:, s]
    return k_pool, v_pool


def read_pool_blocks(k_pool, v_pool, block_ids):
    """Gather blocks ``block_ids`` (n,) int32 out of the pool — the device
    half of swap-out.  Advanced indexing returns a copy, so later in-place
    pool writes never reach the staged handle."""
    idx = block_ids.long()
    return k_pool[:, idx], v_pool[:, idx]


def prompt_cache_to_blocks(cache, block_size: int):
    """Reshape a single-sequence prefilled cache (padded to a multiple of
    ``block_size``) into per-block K/V: (L, 1, nb*bs, Kv, hd) ->
    (L, nb, bs, Kv, hd)."""
    k, v = cache["k"], cache["v"]
    L, _, spad, kv_heads, hd = k.shape
    nb = spad // block_size
    shape = (L, nb, block_size, kv_heads, hd)
    return k[:, 0].reshape(shape), v[:, 0].reshape(shape)
