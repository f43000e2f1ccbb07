"""Architecture registry of the port and its random-batch maker.

Only the architectures whose whole train path the port runs are
registered; the others come in with the slice that ports their mixers,
and until then :func:`get_config` raises ``KeyError`` for them.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device

ARCHS: Dict[str, str] = {
    "yi-6b": "yi_6b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
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
}
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
    :data:`FULL_WIDTH_LAYERS` layers, on the hand-written kernels."""
    return dataclasses.replace(get_config(arch),
                               num_layers=FULL_WIDTH_LAYERS[arch],
                               use_pallas=True)


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0, *,
               device: Optional[Union[str, torch.device]] = None
               ) -> Dict[str, torch.Tensor]:
    """A batch of uniform random tokens and labels, drawn on ``device``
    from a generator seeded with ``seed`` (the counterpart of
    ``repro.configs.make_batch``; the two draw different numbers)."""
    if cfg.enc_layers or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: frames/frontend batches come with the slice that "
            f"ports encoder-decoder and frontend models")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (batch, seq_len)
    return {
        "tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                device=dev),
        "labels": torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                device=dev),
    }
