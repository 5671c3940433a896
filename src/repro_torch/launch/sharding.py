"""Sharding rules: params / batches / caches -> partition specs (the twin of
the JAX package's ``launch/sharding.py``), and the placement of the port's
parameters by them.

A spec is a tuple with one entry per dim of the JAX leaf — an axis name, a
tuple of axis names, or None — as ``jax.sharding.PartitionSpec`` is (``()``
is ``P()``, replicated).  The rules are pure functions of leaf paths,
shapes, the mesh's axis sizes and ``cfg``, kept line for line with JAX's,
so the port and the JAX package place every leaf alike.  The port walks
its own parameters by their JAX leaf paths (``bridge.jax_layout``).

Policy (single pod, axes (data, model); multi-pod prepends "pod" to the
batch axes):
  * params: FSDP over "data" on the d_model-ish dim + tensor parallel over
    "model" on heads/d_ff/vocab; MoE experts over "model"; tiny leaves
    replicated.
  * batches: leading batch dim over ("pod","data") when divisible.
  * KV caches: batch over data axes; kv-heads over "model" when divisible,
    else the head dim; recurrent states shard their head dim.

Every rule checks divisibility and falls back to replication.

``place_params`` cuts a full parameter module of any family down to this
rank's blocks and attaches a ``TensorParallel`` (``params.tp``): the
collectives the model's forward runs on those blocks.  The leaves are
placed by ``param_spec`` on the JAX leaf shapes (stacked on L for
``blocks/*`` and the encoder and decoder, on (G, K) for the hybrid's
``mamba/*``, unstacked for its ``shared/*`` and xLSTM's blocks;
``leaf_specs_of``).  What each family's forward does with them:
  * dense, moe, vlm (``models/transformer.py``), zamba2's shared block
    (``models/hybrid.py``), whisper's encoder, decoder and cross
    attention (``models/encdec.py``): attention on the local heads, the
    MLP on the local d_ff, FSDP gathers of the rest;
  * a mamba2 layer (``models/ssm.py``; mamba2, zamba2's backbone): on
    this rank's SSD heads where they divide 'model'
    (``TensorParallel.mamba_view``), whole otherwise;
  * xLSTM (``models/xlstm.py``): every block whole on every rank, its
    splits gathered;
  * the tied or untied embedding and head split over the vocabulary.

Training differentiates through those collectives (``launch/mesh.py``),
each with the backward its consumer needs: an FSDP weight gathered over
the data axes reduce-scatters its gradient (the data ranks saw different
rows); a gather whose result every member computes with alike (the
norms' and the vocabulary-split logits' model-axis gathers) takes this
member's block of the gradient; a row-parallel sum (``wo``, ``w_down``,
the experts, the embedding lookup) passes its gradient through; and the
input of a column-parallel computation over 'model' (``wq``/``wk``/``wv``
on the local heads, ``w_gate``/``w_up``, the vocabulary-split head, a
moe block's local experts and their gates) sums its gradient over
'model' (Megatron's *f*, ``Mesh.copy_to``).  What is left after the
backward — leaves whole over a data axis (the vocabulary-split embedding,
the norms, the router, experts split over 'model' only) summed over it,
and the leaves whole over 'model' whose gradient each model rank holds
only its part of (the K/V projections of a one-kv-head attention, a
mamba2 layer's per-head ``A_log`` / ``dt_bias`` / ``D`` on its SSD heads)
summed over 'model' — is ``TensorParallel.grad_axes``; ``gather_params``
is the inverse of ``place_params``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import types
from typing import Dict, Optional, Tuple

import torch

# leaf-name classes
_DOWN = ("wo", "w_down", "out_proj")
_UP = ("wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_q", "w_k", "w_v",
       "w_gates", "w_i", "w_f")
_EMBED = ("embed", "lm_head")
_REPLICATE = ("router", "g_bias", "f_bias", "A_log", "dt_bias", "D",
              "alpha", "enc_pos", "dec_pos", "out_norm", "r_gates")


def _div(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def param_spec(path: str, shape, mesh, cfg=None) -> tuple:
    """Spec of the JAX parameter leaf at ``path`` ("blocks/attn/wq") of
    ``shape`` (the JAX leaf's, stacked axes included)."""
    name = path.split("/")[-1]
    nd = len(shape)
    if nd <= 1 or name in _REPLICATE:
        return ()
    # head-aware TP: sharding an attention projection over 'model' is only
    # clean when the head count divides the axis; fall back to FSDP-only
    if cfg is not None and name in ("wq", "wk", "wv", "wo"):
        heads = cfg.num_heads if name in ("wq", "wo") else cfg.num_kv_heads
        if heads % mesh.shape.get("model", 1) != 0:
            spec = [None] * nd
            d_dim = nd - 2 if name in ("wq", "wk", "wv") else nd - 1
            if _div(shape[d_dim], mesh, "data"):
                spec[d_dim] = "data"
            return tuple(spec)
    if name in _EMBED:
        return tuple(["model" if _div(shape[0], mesh, "model") else None]
                     + [None] * (nd - 1))
    # expert weights (..., E, d, f) detected by moe path
    if "moe" in path and nd >= 3 and name in ("w_gate", "w_up", "w_down"):
        spec = [None] * nd
        e_dim = nd - 3
        if _div(shape[e_dim], mesh, "model"):
            spec[e_dim] = "model"
        return tuple(spec)
    if name in _DOWN:
        spec = [None] * nd
        if _div(shape[-2], mesh, "model"):
            spec[-2] = "model"
        if _div(shape[-1], mesh, "data"):
            spec[-1] = "data"
        return tuple(spec)
    if name in _UP or nd >= 2:
        spec = [None] * nd
        if _div(shape[-2], mesh, "data"):
            spec[-2] = "data"
        if _div(shape[-1], mesh, "model"):
            spec[-1] = "model"
        return tuple(spec)
    return ()


def params_specs(params, mesh, cfg=None) -> Dict[str, tuple]:
    """Port parameter name -> the spec of its own tensor: its JAX leaf's
    spec with the stacked (layer) axes dropped."""
    from repro_torch.bridge import config_of, jax_layout
    cfg = config_of(params, cfg)
    named = dict(params.named_parameters())
    out = {}
    for path, (stack, names) in jax_layout(params, cfg).items():
        for n in names:
            spec = param_spec(path, stack + tuple(named[n].shape), mesh, cfg)
            out[n] = spec[len(stack):] if spec else ()
    return out


# ---------------------------------------------------------------- batches
def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a != "model")


def _dp_size(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _dp_entry(mesh):
    """The spec entry of the batch axes: a lone axis as its bare name, as
    ``PartitionSpec`` normalizes a one-name tuple."""
    dp = batch_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def batch_spec(shape, mesh) -> tuple:
    dp = _dp_entry(mesh)
    if shape and shape[0] % _dp_size(mesh) == 0:
        return (dp,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def batch_specs(batch: Dict, mesh) -> Dict[str, tuple]:
    return {k: batch_spec(tuple(v.shape), mesh) for k, v in batch.items()}


# ---------------------------------------------------------------- caches
def cache_spec(path: str, shape, mesh, cfg, batch: int = -1) -> tuple:
    """KV caches / recurrent states (see module docstring).  ``batch`` is
    the runtime batch the recurrent rule looks for (JAX stashes it on the
    config as ``_runtime_batch``)."""
    name = path.split("/")[-1]
    nd = len(shape)
    dp = _dp_entry(mesh)
    if nd == 0 or name == "pos":
        return ()
    spec = [None] * nd
    if cfg.family in ("dense", "moe", "vlm", "encdec") or \
            name in ("k", "v", "ck", "cv"):
        # (L|G, B, S, Kv, hd): kv-heads over 'model', else the HEAD DIM
        if nd == 5:
            if shape[1] % _dp_size(mesh) == 0:
                spec[1] = dp
            if _div(shape[3], mesh, "model"):
                spec[3] = "model"
            elif _div(shape[4], mesh, "model"):
                spec[4] = "model"
            return tuple(spec)
    # recurrent states: the batch dim (matches the runtime B), then the
    # largest remaining dim over "model" if divisible
    b_dim = None
    for i, s in enumerate(shape):
        if s == batch:
            b_dim = i
            break
    if b_dim is not None and shape[b_dim] % _dp_size(mesh) == 0:
        spec[b_dim] = dp
    rest = [(s, i) for i, s in enumerate(shape)
            if i != b_dim and spec[i] is None]
    rest.sort(reverse=True)
    for s, i in rest:
        if _div(s, mesh, "model"):
            spec[i] = "model"
            break
    return tuple(spec)


def cache_specs(cache: Dict, mesh, cfg, batch_size: int) -> Dict[str, tuple]:
    """``cache_spec`` of every entry of a cache dict at runtime batch
    ``batch_size``."""
    return {k: cache_spec(k, tuple(v.shape), mesh, cfg, batch_size)
            for k, v in cache.items()}


# ---------------------------------------------------------------- paged pools
def kv_shard_ways(mesh, cfg) -> int:
    """How many ways the paged KV pool's per-block BYTES divide over the
    'model' axis: kv-heads when divisible, else the head dim, else 1
    (replication fallback, ``cache_spec``'s preference order).  ``PagedKV``
    multiplies its default pool capacity by this."""
    m = mesh.shape.get("model", 1)
    if m <= 1:
        return 1
    if cfg.num_kv_heads % m == 0 or cfg.head_dim % m == 0:
        return m
    return 1


def paged_cache_spec(path: str, shape, mesh, cfg,
                     data_shards: int = 1) -> tuple:
    """Specs for the PAGED cache ``{k, v, table, pos}``: the pool
    ``(L, num_blocks, block_size, Kv, hd)``'s dim 1 is the BLOCK dim, which
    takes the dp axes only when the host allocator is per-shard
    (``data_shards`` equals the dp size and each shard owns a contiguous id
    range, ``paged_cache.ShardedBlockPool``); kv-heads over 'model' when
    divisible, else the head dim, else replication."""
    name = path.split("/")[-1]
    nd = len(shape)
    dp = _dp_entry(mesh)
    spec = [None] * nd
    if nd == 0 or name == "pos":
        return ()
    if name == "table":            # (B, max_blocks): slot rows over dp
        if shape[0] % _dp_size(mesh) == 0:
            spec[0] = dp
        return tuple(spec)
    if nd == 5:                    # k/v pool (L, NB, bs, Kv, hd)
        if data_shards == _dp_size(mesh) > 1 and shape[1] % data_shards == 0:
            spec[1] = dp           # per-shard block ranges
        if _div(shape[3], mesh, "model"):
            spec[3] = "model"
        elif _div(shape[4], mesh, "model"):
            spec[4] = "model"
        return tuple(spec)
    return tuple(spec)


def paged_cache_specs(cache: Dict, mesh, cfg, data_shards: int = 1):
    return {k: paged_cache_spec(k, tuple(v.shape), mesh, cfg, data_shards)
            for k, v in cache.items()}


def replicated_specs(params) -> Dict[str, tuple]:
    """Fully-replicated placement (the data-parallel edge's params)."""
    return {n: () for n, _ in params.named_parameters()}


# ---------------------------------------------------------------- placement
def _has(spec, axis: str, dim: int) -> bool:
    """True when ``spec`` puts ``axis`` on ``dim``."""
    try:
        return spec[dim] == axis
    except IndexError:
        return False


# the model-axis splits a forward computes on (column-parallel projections,
# row-parallel outputs); every other split of a block leaf is gathered
# before the layer runs
_COMPUTE_SPLITS = {"attn/wq": -1, "attn/wk": -1, "attn/wv": -1,
                   "attn/wo": -2, "cross/wq": -1, "cross/wk": -1,
                   "cross/wv": -1, "cross/wo": -2, "mlp/w_gate": -1,
                   "mlp/w_up": -1, "mlp/w_down": -2, "moe/w_gate": -3,
                   "moe/w_up": -3, "moe/w_down": -3}
# the JAX path prefix of each family's attention + MLP leaves (the ones
# ``TensorParallel``'s attention and MLP splits read): the decoder's
# blocks, zamba2's shared block, whisper's decoder (its encoder's specs
# are the same); the pure recurrent families have none
_ATTN_GROUP = {"dense": "blocks/", "moe": "blocks/", "vlm": "blocks/",
               "hybrid": "shared/", "encdec": "decoder/"}
# the JAX path prefix of each family's mamba2 layers
_MAMBA_GROUP = {"ssm": "blocks/", "hybrid": "mamba/"}


@dataclasses.dataclass
class TensorParallel:
    """What a placed parameter module's forward does on each rank's
    blocks: ``cfg`` is the LOCAL config (heads and d_ff cut by the model
    axis where the rules split them), ``full_cfg`` the model's.  ``block``
    holds the spec of each leaf of an attention + MLP block (the same for
    every layer; zamba2's shared block, whisper's encoder and decoder
    blocks), ``specs`` every leaf's, by its JAX path with the stacked axes
    dropped (``leaf_specs_of``).  ``attn_heads``: the attention runs on
    this rank's query heads (the model-axis splits of ``wq`` / ``wo`` are
    computed on and ``wo``'s partials summed); False gathers them and runs
    every head on every rank (``_local_cfg``).  ``ssd_heads``: each mamba2
    layer runs on this rank's SSD heads (``mamba_view``); False runs it
    whole.  ``partial``: the JAX paths of the leaves whole over 'model'
    whose gradient each model rank holds only its part of."""
    mesh: object
    full_cfg: object
    cfg: object
    block: Dict[str, tuple]
    embed: tuple
    head: tuple
    attn_heads: bool = True
    rows: Optional["DataRows"] = None
    specs: Optional[Dict[str, tuple]] = None
    ssd_heads: bool = False
    partial: frozenset = frozenset()

    @contextlib.contextmanager
    def training(self, rows: "DataRows"):
        """Within: the forward takes ``rows``' view of the batch (a moe
        block's load-balance loss over the global batch)."""
        prev, self.rows = self.rows, rows
        try:
            yield self
        finally:
            self.rows = prev

    # ------------------------------------------------------------ weights
    def _full(self, t, spec, keep=None, model_grad: str = "local"):
        """``t`` with every split of ``spec`` all-gathered (one collective
        per split dim) except a 'model' split on dim ``keep`` (negative).
        A data gather reduce-scatters its gradient; a model gather takes
        this member's block of it (``"local"``: every model rank computes
        alike on the whole) or reduce-scatters it (``"sum"``)."""
        for dim, ax in enumerate(spec):
            if ax is None or (ax == "model" and keep is not None
                              and dim - len(spec) == keep):
                continue
            t = self.mesh.all_gather(t, ax, dim=dim, grad=model_grad
                                     if ax == "model" else "sum")
        return t

    def compute_split(self, rel: str):
        """The model-axis split of an attention / MLP / moe leaf (``rel``,
        its path inside the block) the forward computes on, or None."""
        if rel.split("/")[0] in ("attn", "cross") and not self.attn_heads:
            return None
        return _COMPUTE_SPLITS.get(rel)

    def gather_block(self, blk):
        """FSDP: the layer's weights with every split all-gathered except
        the model-axis splits the forward computes on (``_COMPUTE_SPLITS``).
        The rules also split the per-layer norms' d over 'model' (their
        stacked (L, d) JAX leaf takes (data, model)); the layer axis is no
        tensor dim here, so each rank keeps every layer's slice."""
        def full(name, t):
            return self._full(t, self.block[name], self.compute_split(name))

        def group(kind, d):
            return None if d is None else \
                {k: full(f"{kind}/{k}", v) for k, v in d.items()}

        return types.SimpleNamespace(
            attn_norm=full("attn_norm", blk.attn_norm),
            mlp_norm=full("mlp_norm", blk.mlp_norm),
            attn=group("attn", blk.attn), mlp=group("mlp", blk.mlp),
            moe=group("moe", blk.moe))

    def gather_tree(self, prefix: str, tree, keep=None,
                    model_grad: str = "local") -> Dict:
        """A sub-tree of the parameters at JAX path ``prefix`` ("encoder",
        "shared", "blocks/3") as nested dicts of its leaves, each gathered
        by ``_full`` (``keep(rel)`` the model split to keep, by the leaf's
        path inside the sub-tree; None gathers every split)."""
        out: Dict = {}
        for n, t in tree.named_parameters():
            rel = n.replace(".", "/")
            *head, last = rel.split("/")
            node = out
            for k in head:
                node = node.setdefault(k, {})
            node[last] = self._full(t, self.specs[f"{prefix}/{rel}"],
                                    keep(rel) if keep else None,
                                    model_grad)
        return out

    def mamba_view(self, prefix: str, p) -> Dict:
        """A mamba2 layer's weights as this rank computes with them.

        Whole (``ssd_heads`` False): every split gathered.  On this rank's
        SSD heads: ``norm`` and ``out_proj`` keep their model split (di is
        head-major, so it is this rank's heads' columns and rows); ``in_proj``
        and the conv, whose model splits cut the concatenated [z | x | B |
        C | dt] and [x | B | C] columns off the head boundaries, are
        gathered whole and cut to this rank's z, x and dt columns and
        channels beside the whole B and C — their gradient reduce-scattered
        (``model_grad="sum"``: each model rank's holds its heads' columns
        and its part of B and C's); ``A_log``, ``dt_bias`` and ``D``
        (replicated) cut to this rank's heads."""
        if not self.ssd_heads:
            return self.gather_tree(prefix, p)
        w = self.gather_tree(prefix, p, {"norm": -1, "out_proj": -2}.get,
                             model_grad="sum")
        from repro_torch.models.ssm import _mamba_dims
        di, N, _, H = _mamba_dims(self.full_cfg)
        m, i = self.mesh.shape["model"], self.mesh.axis_index("model")
        dl, hl = di // m, H // m

        def cols(t, *spans):
            return torch.cat([t[..., lo:lo + n] for lo, n in spans], dim=-1)

        w["in_proj"] = cols(w["in_proj"], (i * dl, dl), (di + i * dl, dl),
                            (2 * di, 2 * N), (2 * di + 2 * N + i * hl, hl))
        w["conv"] = {k: cols(v, (i * dl, dl), (di, 2 * N))
                     for k, v in w["conv"].items()}
        for k in ("A_log", "dt_bias", "D"):
            w[k] = w[k][i * hl:(i + 1) * hl]
        return w

    # ------------------------------------------------------------ inputs
    def _split_heads(self) -> bool:
        return self.attn_heads and _has(self.block.get("attn/wq", ()),
                                        "model", -1)

    def attn_in(self, x):
        """The normed input of an attention that runs on this rank's heads
        (and the encoder output a cross-attention's K/V project): its
        gradient summed over 'model' (Megatron's *f*)."""
        return self.mesh.copy_to(x, "model") if self._split_heads() else x

    def mlp_in(self, x):
        """The normed input of a column-parallel MLP, as ``attn_in``."""
        return self.mesh.copy_to(x, "model") \
            if _has(self.block.get("mlp/w_up", ()), "model", -1) else x

    def head_in(self, x):
        """The final-normed input of a vocabulary-split head, as
        ``attn_in``."""
        return self.mesh.copy_to(x, "model") \
            if _has(self.head, "model", 0) else x

    def ssd_in(self, x):
        """The input of a mamba2 layer on this rank's SSD heads, as
        ``attn_in``."""
        return self.mesh.copy_to(x, "model") if self.ssd_heads else x

    def ssd_sum(self, x):
        """Sum over 'model' of a term of the gated RMSNorm over the whole
        di (each model rank holds its heads' columns), its gradient summed
        over 'model' too: every model rank's output reads the sum."""
        return self.mesh.all_reduce(self.mesh.copy_to(x, "model"), "model")

    # ------------------------------------------------------------ partials
    def reduce_attn(self, a):
        """Row-parallel ``wo``: sum the heads' partial outputs over
        'model'."""
        return self.mesh.all_reduce(a, "model") \
            if self.attn_heads and _has(self.block["attn/wo"], "model", -2) \
            else a

    def reduce_mlp(self, m):
        key = "mlp/w_down"
        return self.mesh.all_reduce(m, "model") \
            if key in self.block and _has(self.block[key], "model", -2) \
            else m

    def reduce_ssd(self, y):
        """Row-parallel ``out_proj`` on this rank's SSD heads: sum over
        'model'."""
        return self.mesh.all_reduce(y, "model") if self.ssd_heads else y

    def moe(self, p, x, cfg):
        """A moe block on this rank's experts: expert parallel over
        'model' at every token count (the tokens are whole on every rank,
        so no data axis splits them and the dropless capacity counts the
        same T as the unsharded ``moe_block``); ``moe_apply`` when every
        rank holds every expert (a replicated edge, or experts that do not
        divide the axis)."""
        from repro_torch.models import moe as MOE
        if _has(self.block["moe/w_up"], "model", -3):
            return MOE.moe_block_sharded(p, x, cfg, self.mesh, (), "model",
                                         rows=self.rows)
        if self.rows is not None:
            return MOE.moe_block(p, x, cfg, rows=self.rows)
        return MOE.moe_apply(p, x, cfg)

    # ------------------------------------------------------------ vocab
    def embed_lookup(self, table, tokens):
        """Token rows of a vocabulary-split (V/m, d) table: each model rank
        looks up the ids in its range, the others contribute zeros, one
        sum over 'model'."""
        if not _has(self.embed, "model", 0):
            return table[tokens.long()]
        n = table.shape[0]
        lo = self.mesh.axis_index("model") * n
        ids = tokens.long() - lo
        inside = (ids >= 0) & (ids < n)
        rows = table[ids.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
        return self.mesh.all_reduce(rows, "model")

    def gather_logits(self, logits):
        """Full-vocabulary logits from each model rank's (..., V/m)."""
        return self.mesh.all_gather(logits, "model", dim=-1) \
            if _has(self.head, "model", 0) else logits

    def unembed(self, head, hn):
        """Full-vocabulary f32 logits of the final-normed ``hn`` through a
        (possibly vocabulary-split) head."""
        from repro_torch.models.layers import unembed
        return self.gather_logits(unembed(head, self.head_in(hn)))

    # ------------------------------------------------------------ leaves
    def _paths(self, params) -> Dict[str, str]:
        return _port_paths(params, self.full_cfg)

    def leaf_specs(self, params) -> Dict[str, tuple]:
        """Port parameter name -> the spec of this rank's tensor (the
        placement ``leaf_placer`` made)."""
        return {n: self.specs[path] for n, path in self._paths(params).items()}

    def grad_axes(self, params) -> Dict[str, Tuple[Tuple[str, ...], ...]]:
        """Port parameter name -> the axis groups its gradient is still
        summed over after the backward, one all-reduce each: the data axes
        that do not split it (an FSDP gather's backward already summed
        over the one that does), and ('model',) for the ``partial`` leaves
        (the K/V projections of an attention whose query heads split over
        'model' while its kv heads do not, a mamba2 layer's per-head
        leaves and the leaves it cuts to its SSD heads that are whole
        over 'model')."""
        data = batch_axes(self.mesh)
        out = {}
        for n, path in self._paths(params).items():
            axes = tuple(a for a in data if a not in self.specs[path])
            out[n] = ((axes,) if axes else ()) + \
                ((("model",),) if path in self.partial else ())
        return out

    def owns(self, params) -> Dict[str, bool]:
        """Port parameter name -> whether this rank's copy counts in a sum
        over the whole model (a leaf whole over an axis counts on that
        axis' first member only)."""
        return {n: all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names
                       if a not in spec)
                for n, spec in self.leaf_specs(params).items()}


@dataclasses.dataclass
class DataRows:
    """How a training batch lies over the data axes: ``split`` when each
    data rank holds its own rows (``batch_spec`` divides the batch), else
    every data rank holds all of them."""
    mesh: object
    split: bool

    @property
    def n_sets(self) -> int:
        """How many distinct row sets the data ranks hold."""
        return _dp_size(self.mesh) if self.split else 1

    @property
    def weight(self) -> float:
        """This rank's weight in a sum over the data ranks that counts
        every row once: 1, or 0 on all but the first data rank when the
        rows are whole on every one."""
        return 1.0 if self.split or all(
            self.mesh.coords[a] == 0 for a in batch_axes(self.mesh)) else 0.0

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks' row sets (no gradient)."""
        return self.mesh.all_reduce(x.detach(), batch_axes(self.mesh)) \
            if self.split else x

    def local(self, batch: Dict) -> Dict:
        """This rank's rows of a global batch (every entry: tokens,
        labels, vlm ``embeds``, encdec ``frames``)."""
        from repro_torch import runtime
        return {k: runtime.local_slice(v, batch_spec(tuple(v.shape),
                                                     self.mesh), self.mesh)
                for k, v in batch.items()}


def data_rows(batch: Dict, mesh) -> DataRows:
    """The ``DataRows`` of a global batch on ``mesh`` (every entry has the
    same leading batch dim)."""
    b = next(iter(batch.values()))
    return DataRows(mesh, batch_spec(tuple(b.shape), mesh)[0] is not None)


def _local_cfg(cfg, specs, mesh):
    """(the config a rank's blocks compute with, whether its attention runs
    on its own query heads).  Query and kv heads split alike: H/m and Kv/m
    heads.  Only the query heads split (``param_spec`` keeps ``wk`` /
    ``wv`` off 'model' when Kv does not divide it): with one kv head (MQA)
    every rank runs its H/m query heads on the full K/V it computes;
    otherwise a rank's query heads may span kv-head groups, and the
    attention runs whole on every rank (``wq`` / ``wo`` gathered over
    'model'), as JAX runs it when the heads do not divide."""
    m = mesh.shape.get("model", 1)
    kw = {}
    q, k = specs.get("attn/wq", ()), specs.get("attn/wk", ())
    q_split, k_split = _has(q, "model", -1), _has(k, "model", -1)
    heads = q_split and (k_split or cfg.num_kv_heads == 1)
    if heads:
        kw["num_heads"] = cfg.num_heads // m
        if k_split:
            kw["num_kv_heads"] = cfg.num_kv_heads // m
    if _has(specs.get("mlp/w_up", ()), "model", -1):
        kw["d_ff"] = cfg.d_ff // m
    return (cfg.replace(**kw) if kw else cfg), heads or not q_split


def _port_paths(params, cfg) -> Dict[str, str]:
    """Port parameter name -> its JAX leaf path."""
    from repro_torch.bridge import jax_layout
    return {n: path for path, (_, names) in jax_layout(params, cfg).items()
            for n in names}


@functools.lru_cache(maxsize=64)
def _specs_at(cfg, axes: Tuple[Tuple[str, int], ...]) -> Dict[str, tuple]:
    from repro_torch.bridge import jax_layout
    from repro_torch.models import Model
    mesh = types.SimpleNamespace(axis_names=tuple(a for a, _ in axes),
                                 shape=dict(axes))
    whole = Model(cfg).init(device="meta")
    named = dict(whole.named_parameters())
    out = {}
    for path, (stack, names) in jax_layout(whole, cfg).items():
        spec = param_spec(path, stack + tuple(named[names[0]].shape), mesh,
                          cfg)
        out[path] = tuple(spec[len(stack):]) if spec else ()
    return out


def leaf_specs_of(cfg, mesh) -> Dict[str, tuple]:
    """JAX leaf path ("blocks/attn/wq", "mamba/in_proj", "shared/mlp/w_up",
    "blocks/3/w_up", "encoder/attn/wq", "embed") -> the spec of each port
    tensor of it: ``param_spec`` on the JAX leaf's shape (stacked on L
    for ``blocks/*`` and the encoder and decoder, on (G, K) for the
    hybrid's ``mamba/*``, unstacked for the hybrid's ``shared/*`` and
    xLSTM's blocks) with the stacked axes dropped.  The shapes are those
    of ``cfg``'s parameters drawn on the meta device."""
    return dict(_specs_at(cfg, tuple((a, int(mesh.shape[a]))
                                     for a in mesh.axis_names)))


def block_specs(cfg, mesh) -> Dict[str, tuple]:
    """The spec of each leaf of an attention + MLP block ("attn/wq" ->
    spec of the (d, H*hd) tensor; the same for every layer): the decoder
    block's, zamba2's shared block's, whisper's decoder block's; empty for
    the pure recurrent families."""
    prefix = _ATTN_GROUP.get(cfg.family)
    if prefix is None:
        return {}
    return {k[len(prefix):]: v for k, v in leaf_specs_of(cfg, mesh).items()
            if k.startswith(prefix)}


def leaf_placer(cfg, mesh):
    """``leaf(path, tensor) -> this rank's block`` of a whole tensor at JAX
    path ``path`` (``leaf_specs_of``'s keys): what ``init_params(place=...)``
    applies to each leaf as it is drawn, so a rank never holds a whole
    large model."""
    from repro_torch import runtime
    specs = leaf_specs_of(cfg, mesh)

    def place(path: str, t: torch.Tensor) -> torch.Tensor:
        return runtime.local_slice(t, specs[path], mesh).contiguous()
    return place


def _partial(cfg, specs, block, heads: bool, ssd: bool) -> frozenset:
    """``TensorParallel.partial``: the K/V projections of every attention
    whose query heads split over 'model' while its kv heads do not; on
    the SSD heads a mamba2 layer's per-head leaves, and ``in_proj`` and the
    conv where their model split does not divide."""
    out = set()
    prefix = _ATTN_GROUP.get(cfg.family)
    if heads and _has(block.get("attn/wq", ()), "model", -1) and \
            not _has(block.get("attn/wk", ()), "model", -1):
        groups = ("encoder/", "decoder/") if cfg.family == "encdec" \
            else (prefix,)
        for g in groups:
            out.update(f"{g}{k}/{w}" for k in ("attn", "cross")
                       for w in ("wk", "wv") if f"{g}{k}/{w}" in specs)
    if ssd:
        mp = _MAMBA_GROUP[cfg.family]
        out.update(mp + k for k in ("A_log", "dt_bias", "D"))
        out.update(mp + k for k in ("in_proj", "conv/w", "conv/b")
                   if "model" not in specs[mp + k])
    return frozenset(out)


def attach_tp(params, mesh, cfg=None):
    """Mark an already-placed (local-block) parameter module with its
    ``TensorParallel`` and return it."""
    from repro_torch.bridge import config_of
    from repro_torch.models.ssm import _mamba_dims
    cfg = config_of(params, cfg)
    specs = leaf_specs_of(cfg, mesh)
    block = block_specs(cfg, mesh)
    V, d = cfg.vocab_size, cfg.d_model
    emb = param_spec("embed", (V, d), mesh, cfg)
    head = param_spec("lm_head", (V, d), mesh, cfg) \
        if not cfg.tie_embeddings else emb
    local, heads = _local_cfg(cfg, block, mesh)
    m = mesh.shape.get("model", 1)
    # SSD heads that divide 'model' divide di (head-major), so norm and
    # out_proj split over it with them
    ssd = cfg.family in _MAMBA_GROUP and m > 1 and \
        _mamba_dims(cfg)[3] % m == 0
    params.tp = TensorParallel(mesh, cfg, local, block, emb, head, heads,
                               specs=specs, ssd_heads=ssd,
                               partial=_partial(cfg, specs, block, heads,
                                                ssd))
    return params


def place_params(params, mesh, cfg=None):
    """This rank's blocks of a full (replicated) parameter module, by
    ``param_spec``, as a copy of the module holding them with ``tp`` set —
    the twin of ``jax.device_put(params, params_shardings(...))``."""
    from repro_torch.bridge import config_of
    from repro_torch.training import tree as T
    cfg = config_of(params, cfg)
    if getattr(params, "tp", None) is not None:
        return params
    place = leaf_placer(cfg, mesh)
    paths = _port_paths(params, cfg)
    out = T.replace(params, [place(paths[n], t.data)
                             for n, t in params.named_parameters()])
    return attach_tp(out, mesh, cfg)


def gather_params(params):
    """The whole (unplaced) parameter module of a placed one, on every
    rank: each leaf all-gathered over the axes its spec splits, in the
    order ``leaf_placer`` cut it — the inverse of ``place_params``."""
    from repro_torch.training import tree as T
    tp = params.tp
    specs = tp.leaf_specs(params)

    def full(name, t):
        for dim, ax in enumerate(specs[name]):
            if ax is not None:
                t = tp.mesh.all_gather(t.detach(), ax, dim=dim)
        return t

    out = T.replace(params, [full(n, t)
                             for n, t in params.named_parameters()])
    del out.tp
    return out


def local_attention(params, mesh, cfg=None):
    """A replicated (data-parallel) model's parameters with every block's
    attention cut to this rank's model-axis heads — column views of
    ``wq``/``wk``/``wv`` and row views of ``wo``, no copies — and a
    ``TensorParallel`` attached that sums the heads' partial outputs over
    'model'; the MLP, norms, embedding and head stay whole.  The schedule
    for a paged pool whose kv-heads split over 'model' under replicated
    weights (the edge): each model rank attends its own whole heads in its
    part of the pool, one (B, T, d) sum per layer instead of moving blocks.
    ``params`` unchanged when the kv-heads do not divide the axis, and for
    the families that are not decoder-only transformers (their attention,
    if any, stays replicated)."""
    from repro_torch.bridge import config_of
    from repro_torch.models.transformer import FAMILIES, Block, Transformer
    cfg = config_of(params, cfg)
    m = mesh.shape.get("model", 1)
    if m <= 1 or cfg.family not in FAMILIES or cfg.num_kv_heads % m \
            or getattr(params, "tp", None):
        return params
    i, hd = mesh.axis_index("model"), cfg.head_dim
    q, kv = cfg.num_heads * hd // m, cfg.num_kv_heads * hd // m

    def attn(a):
        return {"wq": a["wq"][:, i * q:(i + 1) * q],
                "wk": a["wk"][:, i * kv:(i + 1) * kv],
                "wv": a["wv"][:, i * kv:(i + 1) * kv],
                "wo": a["wo"][i * q:(i + 1) * q]}

    blocks = [Block(b.attn_norm, attn(b.attn), b.mlp_norm,
                    **({"moe": dict(b.moe)} if b.moe is not None
                       else {"mlp": dict(b.mlp)}))
              for b in params.blocks]
    out = Transformer(cfg, params.embed, blocks, params.final_norm,
                      params.lm_head)
    specs = {k: () for k in block_specs(cfg, mesh)}
    specs.update({"attn/wq": (None, "model"), "attn/wk": (None, "model"),
                  "attn/wv": (None, "model"), "attn/wo": ("model", None)})
    out.tp = TensorParallel(mesh, cfg, cfg.replace(
        num_heads=cfg.num_heads // m, num_kv_heads=cfg.num_kv_heads // m),
        specs, (), ())
    return out


def init_placed(model, seed: int, mesh, device):
    """``model.init(seed)`` drawn on ``device`` and cut to this rank's
    blocks leaf by leaf (the same values ``place_params`` of the full init
    gives), with ``tp`` attached: how a rank builds a cloud too large to
    hold whole."""
    p = model.init(seed=seed, device=device,
                   place=leaf_placer(model.cfg, mesh))
    return attach_tp(p, mesh, model.cfg)
