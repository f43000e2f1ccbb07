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
}

# The full-width run on one 80 GB card (chip_smoke.py, analysis/step_profile):
# yi-6b at its published widths, depth cut from 32 to 8 layers because the
# bf16 weights + f32 AdamW state of 32 layers alone take 81 GB; batch 2 x 2048.
FULL_WIDTH_LAYERS = 8
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


def full_width_config() -> ModelConfig:
    """yi-6b cut to :data:`FULL_WIDTH_LAYERS` layers, on the hand-written
    attention kernels."""
    return dataclasses.replace(get_config("yi-6b"),
                               num_layers=FULL_WIDTH_LAYERS, use_pallas=True)


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
