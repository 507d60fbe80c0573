"""Architecture registry of the port: ``get_config(name)`` /
``get_smoke_config(name)`` / ``list_archs()``.

The ten configuration modules are copies, as data, of ``repro.configs``'
(the exact published hyperparameters plus a reduced smoke variant); the
port keeps its own copies so that it never imports the JAX package.
All ten run in the port: the dense archs, mixtral-8x7b,
granite-moe-1b-a400m, hymba-1.5b, xlstm-350m, the encoder-decoder
whisper-large-v3 and pixtral-12b with its vision stub.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_ARCH_MODULES = {
    "hymba-1.5b": "repro_torch.configs.hymba_1p5b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1p1b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}

__all__ = ["ArchConfig", "SHAPES", "ShapeConfig", "get_config",
           "get_smoke_config", "list_archs"]


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return importlib.import_module(_ARCH_MODULES[name]).SMOKE_CONFIG
