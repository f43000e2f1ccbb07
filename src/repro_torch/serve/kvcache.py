"""Paged KV cache: fixed-size pages, a host-side free list, per-slot page
lists (``repro/serve/kvcache.py``).

The serving engine's cache is one flat pool of ``num_pages`` fixed-size
pages per layer (page 0 is reserved as a trash page -- see below), plus a
``(num_slots, pages_per_slot)`` **page table** mapping each slot's logical
page index to a physical page id.  Requests own disjoint physical pages,
so K/V written for one request can never be read by another: the decode
step gathers a slot's logical view ``pages[page_table[slot]]`` and masks
positions ``> pos`` -- unallocated table entries point at the trash page,
whose contents are always masked out (``exp(-inf) == 0`` exactly, so
garbage never perturbs a single bit of an active slot's output).

Allocation is host-side and synchronous with admission (the scheduler
decides *which* request joins; the allocator decides whether its pages
fit), so the decode step never allocates: it only gathers views and
scatters the new token's K/V through the table.  Inactive slots route
their writes to the trash page (``where(active, phys, 0)``) -- a retired
slot can keep riding in the batch without corrupting pages that have been
freed and re-issued to someone else.

A request's full page span (``prompt + max_new`` tokens) is allocated at
admission; pages do not grow lazily during decode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.config import ModelConfig, layer_groups
from repro_torch.dist import sharding
from repro_torch.models.lm import DTYPES, stacked_zeros
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

#: physical page id reserved as the write target for inactive slots and
#: the read target of unallocated page-table entries; never allocated.
TRASH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Static geometry of one serving session's cache pool.

    ``num_slots`` bounds concurrent requests; ``pages_per_slot *
    page_size`` bounds a single request's total context (prompt +
    generated).  ``num_pages`` includes the reserved trash page, so the
    usable pool is ``num_pages - 1`` pages.
    """
    num_slots: int
    page_size: int
    pages_per_slot: int
    num_pages: int

    def __post_init__(self):
        if min(self.num_slots, self.page_size, self.pages_per_slot) < 1:
            raise ValueError(f"degenerate geometry {self}")
        if self.num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")

    @property
    def max_context(self) -> int:
        """Longest context one slot can hold."""
        return self.pages_per_slot * self.page_size

    @property
    def capacity_tokens(self) -> int:
        """Token capacity of the usable (non-trash) pool."""
        return (self.num_pages - 1) * self.page_size

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)


def default_geometry(num_slots: int = 4, page_size: int = 16,
                     max_context: int = 128,
                     num_pages: Optional[int] = None) -> PageGeometry:
    """Geometry with every slot able to reach ``max_context``; the default
    pool is fully provisioned (no oversubscription), so admission never
    deadlocks on pages."""
    per = -(-max_context // page_size)
    pages = num_pages if num_pages is not None else num_slots * per + 1
    return PageGeometry(num_slots=num_slots, page_size=page_size,
                        pages_per_slot=per, num_pages=pages)


class BlockAllocator:
    """Host-side free list over the physical pages (page 0 excluded).

    Pure bookkeeping -- allocation happens at admission on the host, never
    inside a step.  Pages are handed out lowest-id-first so runs are
    reproducible.
    """

    def __init__(self, geom: PageGeometry):
        self.geom = geom
        self._free = list(range(geom.num_pages - 1, TRASH_PAGE, -1))
        self.allocs = 0
        self.frees = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n physical pages, or None if the pool can't satisfy it."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.allocs += n
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == TRASH_PAGE:
                raise ValueError("attempt to free the trash page")
            if p in self._free:
                raise ValueError(f"double free of page {p}")
            self._free.append(p)
        self._free.sort(reverse=True)
        self.frees += len(pages)


# ---------------------------------------------------------------------------
# Device-side paged cache tensors (grouped like lm.init_cache)
# ---------------------------------------------------------------------------

def supports(cfg: ModelConfig) -> Optional[str]:
    """None if the serve engine can run this config, else the reason not.

    Attention-family caches (attn / local / mla) are paged.  Recurrent
    mixers (ssd / rglru) keep O(1) per-slot state and need a
    padding-aware prefill (a right-padded prompt corrupts a recurrent
    state); enc-dec and modality frontends need per-slot side inputs.
    Their prefill/decode contract is the ``models.lm`` level's
    (``tests/test_torch_decode.py``).
    """
    if cfg.enc_layers:
        return "encoder-decoder configs need per-slot encoder caches"
    if cfg.frontend:
        return "modality-frontend configs need per-slot frontend inputs"
    for unit, _ in layer_groups(cfg):
        for mixer, _ffn in unit:
            if mixer not in ("attn", "local", "mla"):
                return f"mixer kind {mixer!r} has no paged decode path yet"
    return None


def check_model_parallel(cfg: ModelConfig, T: int,
                         whole: frozenset = frozenset()) -> None:
    """Raise ``ValueError`` naming the arch when the serving grid's ``T``
    model ranks do not split what it shards over them: an attn/local
    layer's query and KV heads, a dense FFN's ``d_ff``, a MoE layer's
    experts.  The reference refuses the same layouts (GSPMD cannot place
    4 KV heads over a 16-wide ``model`` axis).  ``whole``: the kinds the
    grid runs whole under the rules in force (``dist/sharding.
    grid_whole``), which shard nothing: the heads where a ``kv_seq``
    override takes ``model``."""
    if T <= 1:
        return
    kinds = {k for unit, _ in layer_groups(cfg) for k in unit}
    need = {}
    if "attn" not in whole and any(m in ("attn", "local") for m, _ in kinds):
        need.update(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    if "ffn" not in whole and cfg.d_ff > 0 \
            and any(f == "dense" for _, f in kinds):
        need["d_ff"] = cfg.d_ff
    if "moe" not in whole and cfg.moe is not None \
            and any(f == "moe" for _, f in kinds):
        need["num_experts"] = cfg.moe.num_experts
    bad = {k: v for k, v in need.items() if v % T}
    if bad:
        raise ValueError(f"{cfg.name}: {T} model ranks do not divide "
                         f"{bad}; the serving grid shards them over "
                         f"'model'")


def _layer_pages(kinds, cfg: ModelConfig, geom: PageGeometry,
                 dtype: torch.dtype) -> Params:
    """One layer's page pools, as meta tensors."""
    mixer, _ = kinds
    P_, ps = geom.num_pages, geom.page_size
    meta = lambda *shape: torch.empty(shape, dtype=dtype, device="meta")
    if mixer in ("attn", "local"):
        shape = (P_, ps, cfg.num_kv_heads, cfg.head_dim)
        return {"self": {"k": meta(*shape), "v": meta(*shape)}}
    if mixer == "mla":
        return {"self": {"ckv": meta(P_, ps, cfg.mla.kv_lora_rank),
                         "kr": meta(P_, ps, cfg.mla.qk_rope_head_dim)}}
    raise ValueError(f"unsupported mixer {mixer!r} (see kvcache.supports)")


def init_paged_cache(cfg: ModelConfig, geom: PageGeometry,
                     device=None, model_parallel: int = 1) -> list:
    """Paged cache groups, laid out exactly like ``lm.init_cache``'s (a
    leading per-group ``count`` dim), so the group loops can zip params
    and cache.  ``model_parallel`` T > 1: the pool of one of the serving
    grid's T model ranks, its block under
    ``dist/sharding.serve_grid_state_pspec`` (every model rank's has the
    same shape): an attn/local pool holds ``Hkv / T`` KV heads, an MLA
    pool is whole."""
    reason = supports(cfg)
    if reason:
        raise NotImplementedError(f"serve: {cfg.name}: {reason}")
    check_model_parallel(cfg, model_parallel)
    dtype = DTYPES[cfg.dtype]
    pool = [[stacked_zeros(_layer_pages(kinds, cfg, geom, dtype), count,
                           "meta") for kinds in unit]
            for unit, count in layer_groups(cfg)]
    if model_parallel > 1:
        mesh = sharding.Mesh((1, model_parallel), ("data", "model"))
        specs = sharding.serve_grid_state_pspec({"groups": pool}, cfg, mesh)
        pool = sharding.local_shapes(specs["groups"], pool, mesh)
    return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                          device=device), pool)


def paged_cache_shapes(cfg: ModelConfig, geom: PageGeometry,
                       model_parallel: int = 1) -> list:
    return init_paged_cache(cfg, geom, device="meta",
                            model_parallel=model_parallel)


def cache_bytes(cfg: ModelConfig, geom: PageGeometry,
                model_parallel: int = 1) -> int:
    """Bytes of the paged pool (for sizing / roofline reporting): one of
    ``model_parallel`` model ranks' pool."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        paged_cache_shapes(cfg, geom, model_parallel)))
