"""Configurations of the port: the registry of the LM archs it serves and
trains, under the reference's arch ids (``repro/configs``; each a reduced
``ArchDef`` with what serving and training read), and the paper's ANN
experiments (``ann_paper``)."""
from __future__ import annotations

import dataclasses

from . import (deepseek_v3_671b, gemma3_12b, h2o_danube_1_8b, qwen3_moe_30b_a3b,
               tinyllama_1_1b)


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str          # lm
    model_cfg: object    # models.transformer.LMConfig at published widths
    smoke_cfg: object    # the reference's reduced config for CPU tests
    optimizer: str       # adamw | adafactor, the reference's per arch


_ARCHS = {m.ARCH_ID: ArchDef(m.ARCH_ID, "lm", m.CONFIG, m.SMOKE, m.OPTIMIZER)
          for m in (tinyllama_1_1b, h2o_danube_1_8b, qwen3_moe_30b_a3b, gemma3_12b,
                    deepseek_v3_671b)}


def get_arch(arch_id: str) -> ArchDef:
    return _ARCHS[arch_id]


def list_archs() -> list[str]:
    return list(_ARCHS)
