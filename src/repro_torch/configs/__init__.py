"""Configurations of the port: the registry of the archs it serves and
trains, under the reference's arch ids (``repro/configs``; each an
``ArchDef`` with what serving and training read; the recsys and GNN train
steps are ``common.cell_train_step``), and the paper's ANN experiments
(``ann_paper``)."""
from __future__ import annotations

from . import (autoint, bert4rec, deepfm, deepseek_v3_671b, dlrm_mlperf, gemma3_12b,
               graphsage_reddit, h2o_danube_1_8b, qwen3_moe_30b_a3b, tinyllama_1_1b)
from .common import (GNN_SHAPES, RECSYS_SHAPES, ArchDef, cell_config,  # noqa: F401
                     cell_train_step)

_ARCHS = {m.ARCH_ID: ArchDef(m.ARCH_ID, m.FAMILY, m.CONFIG, m.SMOKE, m.OPTIMIZER)
          for m in (tinyllama_1_1b, h2o_danube_1_8b, qwen3_moe_30b_a3b, gemma3_12b,
                    deepseek_v3_671b, graphsage_reddit, bert4rec, dlrm_mlperf, autoint,
                    deepfm)}


def get_arch(arch_id: str) -> ArchDef:
    return _ARCHS[arch_id]


def list_archs(family: str | None = None) -> list[str]:
    """Every arch id, or those of one family (lm | recsys | gnn)."""
    return [a for a, ad in _ARCHS.items() if family in (None, ad.family)]

