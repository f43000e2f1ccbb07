"""Architecture registry of the port (the JAX package's ten archs), the
(arch x shape) cell matrix with its documented skips, input specs (meta
tensors, never allocated) and the random-batch maker."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.device import resolve_device

ARCHS: Dict[str, str] = {
    "yi-6b": "yi_6b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-67b": "deepseek_67b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "minicpm3-4b": "minicpm3_4b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "internvl2-26b": "internvl2_26b",
}

# The full-width runs on one 80 GB card (chip_smoke.py, analysis/step_profile):
# each arch at its published widths with its depth cut so that the bf16
# weights + f32 AdamW state (about 23.4 bytes per parameter at the
# optimizer's peak) leave room for the deepest step's activations.
FULL_WIDTH_LAYERS: Dict[str, int] = {
    # 32 layers: 5.80 B parameters, 81 GB of state alone.  8: 1.65 B.
    "yi-6b": 8,
    # 64 layers: 2.70 B parameters, ~63 GB at the optimizer's peak before
    # any activation.  32: 1.42 B, ~33 GB, leaving room for 32 live layers.
    "mamba2-2.7b": 32,
    # 26 layers: 2.89 B parameters, ~68 GB at the optimizer's peak.  12 are
    # four whole (rglru, rglru, local) units, one layer group: 8 RG-LRU and
    # 4 local-attention layers, 1.68 B parameters (655 M of them the tied
    # 256k embedding), about yi-6b's 8 layers.  Depth cycle 12, 3, 9, 6.
    "recurrentgemma-2b": 12,
    # 34 layers: ~94 M parameters a layer plus the tied 262144-row
    # embedding (671 M).  12 are two whole (5 local + 1 global) periods,
    # one layer group: 1,803,614,720 parameters, ~42.2 GB of state.  Depth
    # cycle 12, 6, 12, 6 (depths snap to whole 6-layer periods).
    "gemma3-4b": 12,
    # 94 layers of 128 experts: one layer holds 2.42 B expert parameters,
    # so no layer fits whole (1 layer, all 128 experts: 3,733,467,136
    # parameters, 87.4 GB of state).  With FULL_WIDTH_EXPERTS' share, 4
    # layers: 2,137,034,752 parameters, ~50.0 GB.  Depth cycle 4, 1, 3, 2.
    "qwen3-moe-235b-a22b": 4,
    # 27 layers: 15,496,769,024 parameters, ~363 GB of state (each of the
    # 26 MoE layers holds 64 experts of width 1408, 571 M parameters).  4
    # are the dense layer 0 and 3 MoE layers with all 64 experts:
    # 2,045,267,968 parameters, ~47.9 GB.  Depth cycle 4, 1, 3, 2.
    "deepseek-v2-lite-16b": 4,
    # 62 layers: 4,073,937,408 parameters, ~95.3 GB.  24: 1,692,289,536
    # (188 M of them the tied embedding), ~39.6 GB.  Depth cycle 24, 6,
    # 18, 12.
    "minicpm3-4b": 24,
    # 12 + 12 layers, whole: 715,454,464 parameters (262,406,144 of them
    # the tied 256256-row embedding, 201,352,192 the encoder), ~16.7 GB.
    # The encoder is cut with the decoder (an enc-dec cut names both
    # stacks' depth).  Depth cycle 24, 6, 18, 12 over the combined stack.
    "seamless-m4t-medium": 12,
    # 48 layers: 19,293,345,792 parameters, 390,082,560 a layer plus the
    # tied 92672-row embedding (569,376,768).  4: 2,129,707,008, ~49.8 GB.
    # Depth cycle 4, 1, 3, 2.
    "internvl2-26b": 4,
    # deepseek-67b has no entry: its untied 102400 x 8192 pair is 1.68 B
    # parameters and a layer 0.69 B, so 2 layers take 3,061,882,880
    # parameters, 71.6 GB of state before any logit or activation, and 1
    # layer (55.5 GB) has no SPB cycle.
}
# The experts one card holds of each MoE layer at full width: the published
# 128 of qwen3-moe-235b-a22b over a 16-way expert-parallel group (two 8-GPU
# nodes) leave 8 a rank; the card is rank 0 and holds experts 0-7.  The
# router keeps its 128 outputs and top-8.
FULL_WIDTH_EXPERTS: Dict[str, int] = {"qwen3-moe-235b-a22b": 8}
FULL_WIDTH_BATCH = 2
FULL_WIDTH_SEQ = 2048


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port has: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def full_width_config(arch: str) -> ModelConfig:
    """``arch`` at its published widths, cut to its
    :data:`FULL_WIDTH_LAYERS` layers (and to its
    :data:`FULL_WIDTH_EXPERTS` share of each MoE layer; an
    encoder-decoder's encoder to as many layers as its decoder), on the
    hand-written kernels."""
    cfg = get_config(arch)
    if arch not in FULL_WIDTH_LAYERS:
        raise KeyError(f"{arch!r} has no full-width cut that fits one 80 GB "
                       f"card with an SPB cycle; the cuts: "
                       f"{sorted(FULL_WIDTH_LAYERS)}")
    layers = FULL_WIDTH_LAYERS[arch]
    over = dict(num_layers=layers, use_pallas=True)
    if cfg.enc_layers:
        over["enc_layers"] = layers
    if arch in FULL_WIDTH_EXPERTS:
        over["moe"] = dataclasses.replace(
            cfg.moe, experts_held=FULL_WIDTH_EXPERTS[arch])
    return dataclasses.replace(cfg, **over)


def cut_config(arch: str, cut: str = "published") -> ModelConfig:
    """``arch``'s config at a cut: ``published`` (:func:`get_config`),
    ``full_width`` (:func:`full_width_config`) or ``reduced``."""
    cuts = {"published": get_config, "full_width": full_width_config,
            "reduced": reduced_config}
    if cut not in cuts:
        raise KeyError(f"unknown cut {cut!r}; known: {sorted(cuts)}")
    return cuts[cut](arch)


# ---------------------------------------------------------------------------
# Cell matrix: which shapes run per arch (the reference's skips)
# ---------------------------------------------------------------------------

def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 500k-context decode needs "
                "sub-quadratic attention (see DESIGN.md §4)")
    return None


def cells(include_skipped: bool = False
          ) -> List[Tuple[str, str, Optional[str]]]:
    """All (arch, shape, skip_reason) cells -- 10 x 4 = 40 total."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            reason = shape_skip_reason(cfg, shape)
            if reason is None or include_skipped:
                out.append((arch, sname, reason))
    return out


# ---------------------------------------------------------------------------
# Input specs: meta tensors in place of jax.ShapeDtypeStruct
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for a train/prefill batch, as :func:`make_batch`
    lays it out (int64 tokens).  ``seq_len`` counts the *total* sequence
    (frontend tokens + text for a VLM); an encoder-decoder's frames and
    text both take ``seq_len``."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    meta = lambda *s, dtype=torch.int64: torch.empty(s, dtype=dtype,
                                                    device="meta")
    out = {}
    if cfg.enc_layers:
        out["frames"] = meta(B, S, cfg.d_model, dtype=dt)
    elif cfg.frontend:
        out["frontend"] = meta(B, cfg.frontend_tokens, cfg.d_model, dtype=dt)
        S -= cfg.frontend_tokens
    out.update(tokens=meta(B, S), labels=meta(B, S))
    return out


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    return torch.empty((shape.global_batch, 1), dtype=torch.int64,
                       device="meta")


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0, *,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, torch.Tensor]:
    """A batch of uniform random tokens and labels, drawn on ``device``
    from a generator seeded with ``seed`` (the counterpart of
    ``repro.configs.make_batch``; the two draw different numbers).  An
    encoder-decoder's batch also holds N(0, 1) ``frames`` (B, S, d_model)
    for the encoder; a frontend config's holds N(0, 1) ``frontend``
    embeddings (B, frontend_tokens, d_model), and its text is the other
    ``seq_len - frontend_tokens`` positions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = {}                          # name: positions
    if cfg.enc_layers:
        feats["frames"] = seq_len
    elif cfg.frontend:
        feats["frontend"] = cfg.frontend_tokens
        seq_len -= cfg.frontend_tokens
    out = {k: torch.randint(0, cfg.vocab_size, (batch, seq_len),
                            generator=gen, device=dev)
           for k in ("tokens", "labels")}
    for name, n in feats.items():
        out[name] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                device=dev).to(getattr(torch, cfg.dtype))
    return out
