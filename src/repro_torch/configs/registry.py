"""Architecture registry (port of the `ARCHS`/`get`/`list_archs` part of
`repro.configs.registry`; its XLA dry-run helpers have no counterpart)."""
from __future__ import annotations

from typing import Dict

from . import (arctic_480b, deepseek_coder_33b, deepseek_moe_16b,
               granite_3_8b, internlm2_20b, llava_next_34b,
               recurrentgemma_9b, smollm_135m, whisper_base, xlstm_1_3b)
from .base import ArchConfig

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        granite_3_8b, internlm2_20b, smollm_135m, deepseek_coder_33b,
        whisper_base, deepseek_moe_16b, arctic_480b, recurrentgemma_9b,
        xlstm_1_3b, llava_next_34b)
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return sorted(ARCHS)
