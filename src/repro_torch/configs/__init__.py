"""Configurations of the port: the registry of the archs it serves and
trains, under the reference's arch ids (``repro/configs``; each an
``ArchDef`` with what serving and training read, ``fsdp`` where the
reference sets it; the recsys and GNN train steps are
``common.cell_train_step``; every cell's step over a mesh is
``common.cell_program``), and the paper's ANN experiments (``ann_paper``)."""
from __future__ import annotations

from . import (autoint, bert4rec, deepfm, deepseek_v3_671b, dlrm_mlperf, gemma3_12b,
               graphsage_reddit, h2o_danube_1_8b, qwen3_moe_30b_a3b, tinyllama_1_1b)
from .common import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ArchDef, Cell,  # noqa: F401
                     Program, cell_config, cell_program, cell_train_step)

_ARCHS = {m.ARCH_ID: ArchDef(m.ARCH_ID, m.FAMILY, m.CONFIG, m.SMOKE, m.OPTIMIZER,
                             fsdp=getattr(m, "FSDP", False))
          for m in (tinyllama_1_1b, h2o_danube_1_8b, qwen3_moe_30b_a3b, gemma3_12b,
                    deepseek_v3_671b, graphsage_reddit, bert4rec, dlrm_mlperf, autoint,
                    deepfm)}


def get_arch(arch_id: str) -> ArchDef:
    return _ARCHS[arch_id]


def list_archs(family: str | None = None) -> list[str]:
    """Every arch id, or those of one family (lm | recsys | gnn)."""
    return [a for a, ad in _ARCHS.items() if family in (None, ad.family)]



def all_cells() -> list[Cell]:
    """Every arch's cells, in the registry's order."""
    return [c for ad in _ARCHS.values() for c in ad.cells()]
