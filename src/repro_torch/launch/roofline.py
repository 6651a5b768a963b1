"""Roofline report of the port, the counterpart of the reference's
``benchmarks/roofline.py``: it reads the dry run's records
(``launch/dryrun.py --json``), adds each LM cell's model flops and the
useful-compute ratio, and prints the per-(arch x shape x mesh) table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --json dryrun_results.json
    PYTHONPATH=src python -m repro_torch.launch.roofline dryrun_results.json

The roofline terms are the dry run's (one NVIDIA H100 80GB HBM3 a rank);
``useful_ratio`` is the model flops a device over the counted flops a
device, ``roofline_frac`` the model flops' time at peak over the largest of
the three terms.
"""
from __future__ import annotations

import argparse
import json

from .. import configs
from .dryrun import PEAK_FLOPS

TOKENS = {"train_4k": 256 * 4096, "prefill_32k": 32 * 32768,
          "decode_32k": 128, "long_500k": 1}


def lm_param_counts(cfg) -> tuple[int, int]:
    """(total, active-per-token) parameter counts, embeddings excluded from
    the active count's MoE terms per standard practice."""
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    embed = V * D * 2  # embed + lm_head
    if cfg.attention == "mla":
        m = cfg.mla
        attn = (D * m.q_lora_rank + m.q_lora_rank * m.n_heads *
                (m.qk_nope_dim + m.qk_rope_dim) + D * m.kv_lora_rank +
                D * m.qk_rope_dim + m.kv_lora_rank * m.n_heads *
                (m.qk_nope_dim + m.v_head_dim) + m.n_heads * m.v_head_dim * D)
    else:
        attn = D * cfg.n_heads * cfg.d_head * 2 + D * cfg.n_kv * cfg.d_head * 2
    dense_ffn = 3 * D * cfg.d_ff
    total = embed + L * attn
    active = embed + L * attn
    if cfg.moe is not None:
        moe = cfg.moe
        expert = 3 * D * moe.d_ff
        shared = 3 * D * moe.shared_d_ff * moe.n_shared
        n_moe = L - cfg.n_dense_prefix
        total += cfg.n_dense_prefix * dense_ffn + n_moe * (
            moe.n_experts * expert + shared + D * moe.n_experts)
        active += cfg.n_dense_prefix * dense_ffn + n_moe * (
            moe.top_k * expert + shared + D * moe.n_experts)
    else:
        total += L * dense_ffn
        active += L * dense_ffn
    return total, active


def model_flops(arch_id: str, shape: str, kind: str) -> float | None:
    """6 x active parameters x tokens for a train cell, 2 x for inference;
    None for the recsys and GNN archs."""
    ad = configs.get_arch(arch_id)
    if ad.family != "lm":
        return None
    _, active = lm_param_counts(ad.model_cfg)
    toks = TOKENS[shape]
    if kind == "train":
        return 6.0 * active * toks
    return 2.0 * active * toks


def report(path: str = "dryrun_results.json", out=print) -> list[dict]:
    with open(path) as f:
        recs = json.load(f)
    rows = []
    out("arch,shape,mesh,status,bottleneck,t_compute_s,t_memory_s,"
        "t_collective_s,hlo_flops,model_flops,useful_ratio,roofline_frac")
    for r in recs:
        if r["status"] != "ok":
            out(f"{r['arch']},{r['shape']},{r['mesh']},{r['status']},,,,,,,,")
            continue
        n_chips = 512 if r["mesh"] == "2x16x16" else 256
        mf = model_flops(r["arch"], r["shape"], r["kind"])
        mf_dev = mf / n_chips if mf else None
        ratio = (mf_dev / r["hlo_flops"]) if mf_dev and r["hlo_flops"] else None
        t_star = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
        frac = (mf_dev / PEAK_FLOPS) / t_star if mf_dev and t_star > 0 else None
        rows.append({**r, "model_flops": mf, "useful_ratio": ratio, "roofline_frac": frac})
        out(f"{r['arch']},{r['shape']},{r['mesh']},ok,{r['bottleneck']},"
            f"{r['t_compute_s']:.3e},{r['t_memory_s']:.3e},"
            f"{r['t_collective_s']:.3e},{r['hlo_flops']:.3e},"
            f"{mf or 0:.3e},{ratio or 0:.3f},{frac if frac is not None else 0:.4f}")
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default="dryrun_results.json",
                    help="the dry run's --json records")
    return report(ap.parse_args(argv).path)


if __name__ == "__main__":
    main()
