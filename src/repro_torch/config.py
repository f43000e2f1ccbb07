"""Typed configuration system for the SPB/Jigsaw training framework.

A copy of ``repro/config.py`` (pure dataclasses, no framework import) so
the PyTorch port imports nothing of the JAX package; the parity tests pin
the two as equal.  One field is the port's own:
``MoEConfig.experts_held``, the share of an expert-parallel layer that
one card holds.  Architecture configs (``repro_torch/configs/<id>.py``)
instantiate :class:`ModelConfig`; shapes come from :data:`SHAPES`;
parallelism from :class:`ParallelConfig`; the paper's technique from
:class:`SPBConfig`.  In the port ``ModelConfig.use_pallas`` selects the
hand-written Hopper attention kernels (``repro_torch/kernels``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN (shared + routed, top-k)."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # 'dense' computes every expert masked (exact, small-scale);
    # 'ep' is the sort-based expert-parallel all_to_all path (production).
    impl: str = "dense"
    # The port's own field (the reference has none): the experts this card
    # holds, the first ``experts_held`` of ``num_experts`` -- rank 0's share
    # of a layer split over num_experts // experts_held ranks.  The router
    # still scores all of them (models/moe.py).  None = all.
    experts_held: Optional[int] = None

    def __post_init__(self):
        held = self.experts_held
        if held is not None and (held <= 0 or self.num_experts % held):
            raise ValueError(f"experts_held={held} must divide num_experts="
                             f"{self.num_experts}")


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    kv_lora_rank: int
    q_lora_rank: Optional[int]
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class LRUConfig:
    """RG-LRU (Griffin / RecurrentGemma) block."""
    lru_width: int = 0          # defaults to d_model
    d_conv: int = 4
    block_width: int = 256      # chunk for the chunked linear recurrence


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    d_model: int
    num_layers: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    d_ff: int = 0
    # Repeating unit of mixer kinds: 'attn' (global), 'local' (sliding
    # window), 'mla', 'ssd', 'rglru'.  num_layers need not be a multiple of
    # len(pattern); the remainder forms a trailing group.
    pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                   # sliding window for 'local'
    moe: Optional[MoEConfig] = None
    moe_skip_first: int = 0           # leading layers that use the dense FFN
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    lru: Optional[LRUConfig] = None
    # Encoder-decoder (seamless-m4t): if enc_layers > 0, num_layers is the
    # decoder depth and the decoder gets cross-attention.
    enc_layers: int = 0
    # Modality frontend stub: input_specs() provides precomputed embeddings.
    frontend: Optional[str] = None    # 'vision'|'audio'
    frontend_tokens: int = 0
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"           # compute/param dtype
    # Chunked-attention block sizes (plain blockwise path).
    attn_q_block: int = 1024
    attn_kv_block: int = 1024
    # Whether the arch supports long_500k (sub-quadratic decode).
    sub_quadratic: bool = False
    # Use the hand-written attention kernels instead of the blockwise path.
    use_pallas: bool = False

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding/logits shard
        over the tensor axis (logits for pad ids are masked in the loss)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


# ---------------------------------------------------------------------------
# Input shapes (assigned): seq_len x global_batch
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    """Mesh + axis roles.  dp axes shard batch; tp axis shards weights;
    the optional pp axis pipelines the layer stack (a ``(stage, data)``
    or ``(stage, data, model)`` mesh from ``launch.mesh.
    make_pipeline_mesh`` — microbatches stream along ``stage`` while
    their batch dim shards over ``data``)."""
    mesh_shape: Tuple[int, ...] = (16, 16)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    dp_axes: Tuple[str, ...] = ("data",)      # ('pod','data') when multi-pod
    tp_axis: str = "model"
    pp_axis: Optional[str] = None             # 'stage' on pipeline meshes
    # Remat policy for the per-layer body: 'none'|'full'|'dots'.
    remat: str = "full"
    # Shard long decode KV caches / sequence over these axes.
    seq_axes: Tuple[str, ...] = ("model",)

    @property
    def all_dp(self) -> Tuple[str, ...]:
        return self.dp_axes

    @property
    def num_dp(self) -> int:
        sizes = dict(zip(self.mesh_axes, self.mesh_shape))
        n = 1
        for a in self.dp_axes:
            n *= sizes[a]
        return n

    @property
    def num_pp(self) -> int:
        """Pipeline stage count (1 when the mesh has no pp axis)."""
        if self.pp_axis is None:
            return 1
        return dict(zip(self.mesh_axes, self.mesh_shape))[self.pp_axis]


# ---------------------------------------------------------------------------
# SPB (the paper's technique)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SPBConfig:
    """Structured Partial Backpropagation.

    mode:
      'off'      -- standard full backprop.
      'temporal' -- TPU-native: the backprop suffix depth cycles over steps
                    (or microbatches); static per compiled step, so XLA
                    truly skips prefix backward compute/memory/collectives.
      'spatial'  -- paper-faithful: per-worker depth via lax.switch inside
                    shard_map over the DP axis; weighted psum aggregation.
    k: number of depth levels (paper: number of workers). Worker/level j
       (1-indexed) backprops through ceil(j*L/k) suffix layers.
    """
    mode: str = "off"
    k: int = 4
    warmup_steps: int = 0             # full backprop for first N steps
    subgroup_reduce: bool = False     # reduce prefix blocks over sub-groups
    lr_rescale: bool = True           # per-block LR scaling (paper Sec 2)
    # Pipeline-parallel sessions snap depths to stage boundaries instead of
    # scan-unit boundaries (0 = not pipelined).  Set by SPBEngine from the
    # mesh's 'stage' axis; keeps schedules/contributors/LR-rescale
    # consistent with what the pipeline actually freezes.
    pipeline_stages: int = 0

    def depths(self, num_layers: int) -> Tuple[int, ...]:
        """Suffix depths for levels j=1..k (ceil(j*L/k), always >= 1)."""
        import math
        return tuple(max(1, math.ceil((j + 1) * num_layers / self.k))
                     for j in range(self.k))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    optimizer: str = "adamw"          # 'adamw' | 'sgdm'
    momentum: float = 0.9
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    num_steps: int = 100
    microbatches: int = 1             # gradient accumulation
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    warmup_steps: int = 10
    # Gradient compression before the DP reduce: 'none'|'topk'|'lowrank'.
    compression: str = "none"
    compression_ratio: float = 0.1


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = ParallelConfig()
    spb: SPBConfig = SPBConfig()
    train: TrainConfig = TrainConfig()


# ---------------------------------------------------------------------------
# Layer-group derivation (scan-over-layers with heterogeneous patterns)
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    """Per-layer (mixer_kind, ffn_kind) for the decoder stack."""
    out = []
    p = cfg.pattern
    for i in range(cfg.num_layers):
        mixer = p[i % len(p)]
        ffn = "moe" if (cfg.moe is not None and i >= cfg.moe_skip_first) else "dense"
        out.append((mixer, ffn))
    return tuple(out)


def layer_groups(cfg: ModelConfig) -> Tuple[Tuple[Tuple[Tuple[str, str], ...], int], ...]:
    """Group layers into (unit, repeat) runs for stacked-param lax.scan.

    The unit is a tuple of (mixer, ffn) kinds of length len(pattern) (or the
    remainder).  Consecutive identical units merge into one scanned group.
    """
    kinds = layer_kinds(cfg)
    p = len(cfg.pattern)
    units = [kinds[i:i + p] for i in range(0, len(kinds), p)]
    groups: list = []
    for u in units:
        if groups and groups[-1][0] == u:
            groups[-1][1] += 1
        else:
            groups.append([u, 1])
    return tuple((tuple(u), int(c)) for u, c in groups)


def total_layers(cfg: ModelConfig) -> int:
    """Flattened SPB depth domain: encoder layers (if any) come first."""
    return cfg.num_layers + cfg.enc_layers


def combined_layer_groups(cfg: ModelConfig):
    """Groups over the full enc+dec stack (SPB counts suffix from output,
    so the encoder is the deepest prefix)."""
    groups = []
    if cfg.enc_layers:
        groups.append(((("attn", "dense"),), cfg.enc_layers))
    groups.extend(layer_groups(cfg))
    return tuple(groups)


def group_layer_offsets(cfg: ModelConfig) -> Tuple[int, ...]:
    """Flattened starting layer index of each group."""
    offs, n = [], 0
    for unit, count in layer_groups(cfg):
        offs.append(n)
        n += len(unit) * count
    return tuple(offs)


def snap_depth(cfg: ModelConfig, depth: int) -> int:
    """Snap an SPB suffix depth to an achievable boundary.

    The differentiable suffix must start at a unit boundary inside a scanned
    group (we split groups by whole units).  The boundary snaps DOWN, i.e.
    the depth snaps UP (>= requested backprop), so convergence is never
    hurt by the quantization; compute savings are therefore conservative.
    Depth is measured over the combined enc+dec stack.
    """
    L = total_layers(cfg)
    depth = max(1, min(depth, L))
    boundary = L - depth              # first differentiable layer index
    # achievable boundaries: group offset + multiple of unit length
    best, off = 0, 0
    for unit, count in combined_layer_groups(cfg):
        p = len(unit)
        for r in range(count + 1):
            b = off + r * p
            if b <= boundary and b > best:
                best = b
            if b > boundary:
                break
        off += p * count
    return L - best


def _flat_unit_lens(cfg: ModelConfig) -> Tuple[int, ...]:
    """Layer count of every scanned unit, flattened over the groups."""
    lens: list = []
    for unit, count in combined_layer_groups(cfg):
        lens.extend([len(unit)] * count)
    return tuple(lens)


def stage_unit_cuts(cfg: ModelConfig, num_stages: int) -> Tuple[int, ...]:
    """Balanced contiguous partition of the flat unit list into stages.

    Returns ``num_stages + 1`` unit-index boundaries: stage ``s`` holds
    units ``[cuts[s], cuts[s+1])``.  Each cut greedily minimizes the
    layer-count deviation from the ideal ``total * s / num_stages``
    (earliest cut wins ties), subject to every stage getting at least one
    unit.  A homogeneous stack whose unit count divides evenly reproduces
    the classic equal split.  Deterministic in (cfg, num_stages) — part of
    the engine step signature.
    """
    lens = _flat_unit_lens(cfg)
    n = len(lens)
    if num_stages <= 0 or num_stages > n:
        raise ValueError(f"{n} scanned units cannot fill {num_stages} "
                         f"pipeline stages")
    csum = [0]
    for u in lens:
        csum.append(csum[-1] + u)
    total = csum[-1]
    cuts = [0]
    for s in range(1, num_stages):
        lo = cuts[-1] + 1
        hi = n - (num_stages - s)
        target = total * s / num_stages
        cuts.append(min(range(lo, hi + 1),
                        key=lambda i: (abs(csum[i] - target), i)))
    cuts.append(n)
    return tuple(cuts)


def stage_layer_counts(cfg: ModelConfig, num_stages: int) -> Tuple[int, ...]:
    """Layers per pipeline stage under :func:`stage_unit_cuts`."""
    lens = _flat_unit_lens(cfg)
    cuts = stage_unit_cuts(cfg, num_stages)
    return tuple(sum(lens[a:b]) for a, b in zip(cuts, cuts[1:]))


def snap_depth_to_stages(cfg: ModelConfig, depth: int,
                         num_stages: int) -> int:
    """Snap an SPB suffix depth UP to a pipeline-stage boundary.

    Under pipeline parallelism the truncation point must be a stage
    boundary (the last ``j`` stages run backward, the first ``k - j``
    forward-only), so a depth of ``d`` layers becomes the layer count of
    the shortest stage suffix covering it — like :func:`snap_depth`, the
    snap is always toward *more* backprop, never less.  Stages may be
    heterogeneous (:func:`stage_layer_counts`); the only hard requirement
    is ``num_stages <=`` the number of scanned units.
    """
    counts = stage_layer_counts(cfg, num_stages)
    depth = max(1, min(depth, total_layers(cfg)))
    acc = 0
    for c in reversed(counts):
        acc += c
        if acc >= depth:
            break
    return acc


def depth_to_bwd_stages(cfg: ModelConfig, depth: Optional[int],
                        num_stages: int) -> int:
    """Map an SPB suffix depth to the pipeline truncation point: the
    number of *live* (backward-running) suffix stages.  The first
    ``num_stages - result`` stages run forward-only; ``None`` = full
    backprop = every stage live.  The single source of truth shared by
    the compiled pipeline steps, the depth policies, and the analyses.
    """
    if depth is None:
        return num_stages
    counts = stage_layer_counts(cfg, num_stages)
    depth = max(1, min(depth, total_layers(cfg)))
    acc, live = 0, 0
    for c in reversed(counts):
        acc += c
        live += 1
        if acc >= depth:
            break
    return live
