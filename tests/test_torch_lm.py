"""The port's LM serving slice on the CPU against live calls into repro.

The same numpy inputs (from a seed) and, for the models, the reference's
own weights carried across by ``models/convert.py`` go through
``repro.models`` (JAX on the CPU) and ``repro_torch.models``. Attention
through ``kernels.ops.flash_attention`` on the CPU is the kernel's plain
version, held against the reference's chunked ``attention_full``, its
Pallas kernel in interpret mode (as ``tests/test_kernels.py`` runs it) and
its dense oracle.

Tolerances: 2e-5 for attention (the reference's own kernel tests); 1e-5
for fp32 model outputs, which differ only in summation order; bf16 cases
within a few bf16 ulps of the outputs' scale, as the two frameworks round
at other places (matmul accumulation, silu).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as j_deepseek
from repro.configs import gemma3_12b as j_gemma
from repro.configs import h2o_danube_1_8b as j_danube
from repro.configs import qwen3_moe_30b_a3b as j_qwen
from repro.configs import tinyllama_1_1b as j_tiny
from repro.kernels import flash_attention as j_flash
from repro.kernels import ref as j_ref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
SMOKES = {"tinyllama-1.1b": j_tiny.SMOKE, "h2o-danube-1.8b": j_danube.SMOKE,
          "qwen3-moe-30b-a3b": j_qwen.SMOKE, "gemma3-12b": j_gemma.SMOKE,
          "deepseek-v3-671b": j_deepseek.SMOKE}
JMODS = {"tinyllama-1.1b": j_tiny, "h2o-danube-1.8b": j_danube,
         "qwen3-moe-30b-a3b": j_qwen, "gemma3-12b": j_gemma,
         "deepseek-v3-671b": j_deepseek}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) \
        else x.float().numpy()


def _port_cfg(jcfg, **over):
    """The port's config for a reference config (same fields, torch dtype;
    an MoE block as the port's MoEConfig, an MLA block as its MLAConfig)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.bfloat16 if jcfg.dtype == jnp.bfloat16 else torch.float32
    if jcfg.moe is not None:
        fields["moe"] = L.MoEConfig(**dataclasses.asdict(jcfg.moe))
    if jcfg.mla is not None:
        fields["mla"] = L.MLAConfig(**dataclasses.asdict(jcfg.mla))
    return T.LMConfig(**{**fields, **over})


def _models(jcfg, seed=0):
    """(reference params, port model carrying the same weights)."""
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jp, convert.lm_params_from_numpy(tree, _port_cfg(jcfg), device="cpu")


def _tokens(vocab, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


# -- attention -----------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, None), (True, 32), (False, None)])
@pytest.mark.parametrize("S,Hq,Hkv", [(128, 2, 2), (256, 4, 2), (128, 4, 1)])
def test_attention_plain_matches_reference(causal, window, S, Hq, Hkv):
    """ops.flash_attention on the CPU (the plain version) and the port's
    attention_full against the reference's chunked attention_full, its
    Pallas kernel (interpret mode) and its dense oracle; GQA ratios 1, 2,
    4."""
    rng = np.random.default_rng(S + 10 * Hq + Hkv)
    B, dh = 2, 32
    q = rng.standard_normal((B, S, Hq, dh), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    layer = L.attention_full(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert torch.equal(got, layer)
    wants = {
        "layers.attention_full": JL.attention_full(jq, jk, jv, causal=causal,
                                                   window=window, kv_chunk=64),
        "pallas (interpret)": j_flash(jq, jk, jv, causal=causal, window=window,
                                      block_q=64, block_k=64, interpret=True),
        "ref.flash_attention_ref": j_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                             window=window),
    }
    for name, want in wants.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40), (False, None)])
@pytest.mark.parametrize("dh,dhv", [(192, 128), (256, 256)])
def test_attention_plain_wide_heads_match_reference(causal, window, dh, dhv):
    """Head dims past 128 (DeepSeek's 192 / 128, Gemma3's 256): the plain
    version against the reference's chunked attention_full, its Pallas
    kernel (interpret mode, the whole dh as one block) and its oracle."""
    rng = np.random.default_rng(dh + dhv)
    B, S, Hq, Hkv = 1, 128, 4, 2
    q = rng.standard_normal((B, S, Hq, dh), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, dhv), dtype=np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.shape == (B, S, Hq, dhv)
    wants = {
        "layers.attention_full": JL.attention_full(jq, jk, jv, causal=causal,
                                                   window=window, kv_chunk=64),
        "pallas (interpret)": j_flash(jq, jk, jv, causal=causal, window=window,
                                      block_q=64, block_k=64, interpret=True),
        "ref.flash_attention_ref": j_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                             window=window),
    }
    for name, want in wants.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("flag", [False, True])
def test_global_override_matches_reference(flag):
    """The hybrid pattern's flag: True turns the window off, as the
    reference ORs it into the mask; False keeps it."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 64, 4, 16), dtype=np.float32) for _ in range(3))
    got = L.attention_full(_t(q), _t(k), _t(v), window=8, global_override=flag)
    want = JL.attention_full(*map(jnp.asarray, (q, k, v)), window=8, kv_chunk=32,
                             global_override=jnp.bool_(flag))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    same = L.attention_full(_t(q), _t(k), _t(v), window=None if flag else 8)
    assert torch.equal(got, same)
    assert torch.equal(L.attention_full(_t(q), _t(k), _t(v), window=8,
                                        global_override=torch.tensor(flag)), got)


def test_attention_plain_bf16_scale_and_head_dims():
    """bf16 in, bf16 out (fp32 scores), a given softmax scale and dhv != dh,
    against the reference's oracle."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 64, 4, 16), dtype=np.float32)
    k = rng.standard_normal((1, 64, 2, 16), dtype=np.float32)
    v = rng.standard_normal((1, 64, 2, 24), dtype=np.float32)
    got = ref.flash_attention_ref(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                  _t(v, torch.bfloat16), window=8, softmax_scale=0.3)
    want = j_ref.flash_attention_ref(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                     jnp.asarray(v, jnp.bfloat16), window=8,
                                     softmax_scale=0.3)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 64, 4, 24)
    # fp32 internals agree to ~1e-6; the bf16 cast may then round one ulp apart
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=1e-6)


# -- blocks --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_swiglu_match_reference(dtype):
    rng = np.random.default_rng(4)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    x = rng.standard_normal((2, 12, 64), dtype=np.float32) * 3
    scale = rng.standard_normal(64, dtype=np.float32)
    tol = FP32_TOL if dtype == "float32" else dict(rtol=2 ** -6, atol=2 ** -6)
    got = L.rms_norm(_t(x, td), _t(scale, td))
    want = JL.rms_norm(jnp.asarray(x, jd), jnp.asarray(scale, jd))
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), **tol)

    h = rng.standard_normal((2, 12, 4, 16), dtype=np.float32)
    pos = np.broadcast_to(np.arange(100, 112), (2, 12)).astype(np.int32)
    got = L.rope(_t(h, td), torch.from_numpy(pos))
    want = JL.rope(jnp.asarray(h, jd), jnp.asarray(pos))
    assert got.dtype == td
    np.testing.assert_allclose(_np(got), _np(want), **tol)

    w = [rng.standard_normal(s, dtype=np.float32) * 0.125 for s in ((64, 96), (64, 96), (96, 64))]
    got = L.swiglu(_t(x, td), *[_t(a, td) for a in w])
    want = JL.swiglu(jnp.asarray(x, jd), *[jnp.asarray(a, jd) for a in w])
    scale_out = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol["rtol"],
                               atol=tol["atol"] * scale_out)


@pytest.mark.parametrize("window", [None, 8])
def test_gqa_forward_full_and_cached_match_reference(window):
    """gqa_forward without a cache (prefill) and with one (a one-token write
    into a cache at length 5, in place), fp32."""
    rng = np.random.default_rng(5)
    D, H, Hkv, dh, B, S = 64, 4, 2, 16, 2, 16
    p = {n: rng.standard_normal(s, dtype=np.float32) * D ** -0.5
         for n, s in (("wq", (D, H * dh)), ("wk", (D, Hkv * dh)),
                      ("wv", (D, Hkv * dh)), ("wo", (H * dh, D)))}
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    kw = dict(n_heads=H, n_kv=Hkv, d_head=dh, rope_theta=10000.0, window=window)
    tp = {n: _t(a) for n, a in p.items()}
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    got, (gk, gv) = L.gqa_forward(tp, _t(x), torch.from_numpy(pos), **kw)
    want, (wk, wv) = JL.gqa_forward(jp, jnp.asarray(x), jnp.asarray(pos), **kw)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FP32_TOL)

    cache = [rng.standard_normal((B, 12, Hkv, dh), dtype=np.float32) for _ in range(2)]
    clen = np.array([5, 5], np.int32)
    x1 = x[:, :1]
    tc = [_t(c) for c in cache]
    got, _ = L.gqa_forward(tp, _t(x1), torch.from_numpy(clen[:, None].copy()), **kw,
                           cache=tc, cache_len=torch.from_numpy(clen))
    want, (wk, wv) = JL.gqa_forward(jp, jnp.asarray(x1), jnp.asarray(clen[:, None]), **kw,
                                    cache=tuple(map(jnp.asarray, cache)),
                                    cache_len=jnp.asarray(clen))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(wk), **FP32_TOL)  # in place
    np.testing.assert_allclose(tc[1].numpy(), np.asarray(wv), **FP32_TOL)


# -- the model -------------------------------------------------------------------


def test_port_configs_copy_the_reference():
    for arch_id, jmod in JMODS.items():
        arch = configs.get_arch(arch_id)
        for mine, theirs in ((arch.model_cfg, jmod.CONFIG), (arch.smoke_cfg, jmod.SMOKE)):
            assert mine == _port_cfg(theirs), arch_id
    assert configs.list_archs("lm") == list(JMODS)


@pytest.mark.parametrize("arch_id", list(SMOKES))
def test_smoke_prefill_and_forward_match_reference(arch_id):
    jcfg = SMOKES[arch_id]
    jp, model = _models(jcfg)
    toks = _tokens(jcfg.vocab, 2, 24)
    h_want, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    h_got = T.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **FP32_TOL)
    want = JT.prefill(jp, jnp.asarray(toks), jcfg)
    got = T.prefill(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_smoke_prefill_bf16_matches_reference():
    """TinyLlama smoke in bf16: logits within 0.05 of the reference's (their
    scale is ~1; the bf16 rounding of two frameworks over two layers), and
    the same argmax on most rows."""
    jcfg = dataclasses.replace(j_tiny.SMOKE, dtype=jnp.bfloat16)
    jp, model = _models(jcfg)
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens(jcfg.vocab, 8, 32)
    want = np.asarray(JT.prefill(jp, jnp.asarray(toks), jcfg))
    got = T.prefill(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=0.05, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).sum() >= 7


def _jax_decode(jp, jcfg, first, steps, B, max_len):
    """The reference's serve loop (launch/serve.py): greedy from ``first``."""
    caches = JT.init_cache(jcfg, B, max_len)
    step = jax.jit(lambda p, t, pos, c: JT.decode_step(p, t, pos, c, jcfg))
    tok = jnp.asarray(first)
    toks, logits = [], []
    for t in range(steps):
        lg, caches = step(jp, tok, jnp.full((B,), t, jnp.int32), caches)
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits.append(np.asarray(lg))
    return np.stack(toks, 1), np.stack(logits, 1)


@pytest.mark.parametrize("arch_id", list(SMOKES))
def test_greedy_decode_matches_reference(arch_id):
    """20 greedy steps, past Danube's window and Gemma3's local window of 8
    (the rings wrap twice; Gemma3's global layers keep max_len slots);
    Qwen3's and DeepSeek's MoE run each row as a group of one token (C =
    1); DeepSeek's MLA layers (the dense prefix first) score the cached
    latent: identical tokens and logits within 1e-5. Each layer's cache has
    the reference's entries, shapes and dtypes."""
    jcfg = SMOKES[arch_id]
    jp, model = _models(jcfg)
    B, steps, max_len = 3, 20, 32
    want_toks, want_logits = _jax_decode(jp, jcfg, np.zeros(B, np.int32), steps, B, max_len)
    caches = T.init_cache(model.cfg, B, max_len, "cpu")
    jcaches = JT.init_cache(jcfg, B, max_len)
    assert len(caches) == len(jcaches) == jcfg.n_layers
    for i, (c, jc) in enumerate(zip(caches, jcaches)):
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k, t in c.items()} == {k: (a.shape, str(a.dtype)) for k, a in jc.items()}
        w = jcfg.layer_window(i)
        size = max_len if w is None else w
        if jcfg.attention == "mla":
            assert c["kv_c"].shape == (B, size, jcfg.mla.kv_lora_rank)
        else:
            assert c["k"].shape == (B, size, jcfg.n_kv, jcfg.d_head)
    tok = torch.zeros(B, dtype=torch.long)
    for t in range(steps):
        lg = T.decode_step(model, tok, torch.full((B,), t, dtype=torch.int32), caches)
        np.testing.assert_allclose(lg.numpy(), want_logits[:, t], **FP32_TOL)
        tok = lg.argmax(-1)
        np.testing.assert_array_equal(tok.numpy(), want_toks[:, t])


@pytest.mark.parametrize("arch_id", list(SMOKES))
def test_prefill_equals_decode(arch_id):
    """The port alone, as tests/test_models_lm.py checks the reference:
    forward's logits at every position == a token-by-token decode; 12
    tokens wrap Gemma3's local rings of 8. Qwen3 at capacity_factor E / K,
    so that C = S and prefill drops nothing, as decode (C = 1 a row) never
    does; at 1.25 the two differ, in the reference too."""
    cfg = configs.get_arch(arch_id).smoke_cfg
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
    model = T.init_params(cfg, seed=3, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg.vocab, B, S, seed=2)).long()
    full = (T.forward(model, toks) @ model.lm_head).float()
    caches = T.init_cache(cfg, B, S, "cpu")
    steps = [T.decode_step(model, toks[:, t], torch.full((B,), t, dtype=torch.int32), caches)
             for t in range(S)]
    err = float((full - torch.stack(steps, 1)).abs().max())
    assert err < 1e-4, err


def test_full_head_layout_matches_reference():
    """TinyLlama's widths (d=2048, GQA 32/4, d_head=64, d_ff=5632) at 2
    layers and vocab 1024, B=1, S=128, fp32."""
    jcfg = dataclasses.replace(j_tiny.CONFIG, n_layers=2, vocab=1024, dtype=jnp.float32,
                               remat=False)
    jp, model = _models(jcfg, seed=2)
    toks = _tokens(jcfg.vocab, 1, 128, seed=5)
    h_want, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    h_got = T.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), rtol=1e-4, atol=1e-4)
    want = np.asarray(h_want[:, -1] @ jp["lm_head"])
    got = T.prefill(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch_id", list(SMOKES))
def test_serve_lm_emits_the_reference_stream(arch_id, capsys):
    jcfg = SMOKES[arch_id]
    jp, model = _models(jcfg)
    want, _ = _jax_decode(jp, jcfg, np.zeros(2, np.int32), 16, 2, 128)
    run = serve.serve_lm(model, batch=2, tokens=16, max_len=128)
    np.testing.assert_array_equal(run.tokens.numpy(), want)
    assert run.tok_per_s > 0 and run.ms_per_token > 0
    assert "[serve] 16 tokens x 2 seqs in" in capsys.readouterr().out


def test_serve_cli_lm_branch(capsys):
    run = serve.main(["--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
                      "--tokens", "10", "--batch", "3", "--max-len", "16"])
    assert run.tokens.shape == (3, 10)
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="exceeds --max-len"):
        serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
                    "--tokens", "10", "--max-len", "8"])


def test_lm_params_from_numpy_rejects_bad_trees():
    jcfg = j_tiny.SMOKE
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = _port_cfg(jcfg)
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params_from_numpy({k: v for k, v in tree.items() if k != "lm_head"},
                                     cfg, "cpu")
    with pytest.raises(ValueError, match="extra"):
        convert.lm_params_from_numpy({**tree, "mtp": np.zeros(3, np.float32)}, cfg, "cpu")
    bad = {**tree, "embed": tree["embed"][:, :32]}
    with pytest.raises(ValueError, match="embed"):
        convert.lm_params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(ValueError, match="float64"):
        convert.lm_params_from_numpy({**tree, "embed": tree["embed"].astype(np.float64)},
                                     cfg, "cpu")


def test_mla_prefix_and_mtp_variants_build():
    """The three parts of DeepSeek-V3's config, each on its own on the Qwen3
    smoke base (MoE): MLA attention in every block; a dense-FFN prefix whose
    blocks are SwiGLUs of d_ff ahead of MoE blocks; the MTP head, a dense
    block beside its proj (2D, D) and norm, which prefill and decode do not
    run. Each builds, prefills and decodes, and so does every arch of the
    registry."""
    base = configs.get_arch("qwen3-moe-30b-a3b").smoke_cfg
    mla = configs.get_arch("deepseek-v3-671b").smoke_cfg.mla
    D = base.d_model
    toks = torch.from_numpy(_tokens(base.vocab, 2, 6)).long()
    for over in (dict(attention="mla", mla=mla), dict(n_dense_prefix=1), dict(mtp=True)):
        cfg = dataclasses.replace(base, **over)
        model = T.init_params(cfg, seed=0, device="cpu")
        blocks = model.blocks()
        assert len(blocks) == cfg.n_layers and len(model.layers) == cfg.n_scan_layers
        assert all(isinstance(b.attn, T.MLAttention if cfg.attention == "mla"
                              else T.GQAttention) for b in blocks)
        assert all(isinstance(b.mlp, T.SwiGLU) and b.mlp.w_gate.shape == (D, cfg.d_ff)
                   for b in model.prefix)
        assert all(isinstance(b.mlp, T.MoE) for b in model.layers)
        assert (model.mtp is not None) == cfg.mtp
        if cfg.mtp:
            assert model.mtp.proj.shape == (2 * D, D) and model.mtp.norm.shape == (D,)
            assert isinstance(model.mtp.layer.mlp, T.SwiGLU)
            assert isinstance(model.mtp.layer.attn, T.GQAttention)
            assert model.mtp.layer.attn.window is None
        logits = T.prefill(model, toks)
        caches = T.init_cache(cfg, 2, 6, "cpu")
        step = T.decode_step(model, toks[:, 0], torch.zeros(2, dtype=torch.int32), caches)
        assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all())
    for arch_id in configs.list_archs("lm"):
        T.Transformer(configs.get_arch(arch_id).smoke_cfg, device="cpu")


# -- Qwen3-MoE and Gemma3 ---------------------------------------------------------


@pytest.mark.parametrize("arch_id,d_head", [("gemma3-12b", 256), ("qwen3-moe-30b-a3b", 128)])
def test_wide_head_smoke_matches_reference(arch_id, d_head):
    """The smoke configs at the published head dims (Gemma3's 256 with its
    5 : 1 pattern as 2 : 1, Qwen3's 128): hidden states and prefill logits
    against the reference's scan, fp32."""
    jcfg = dataclasses.replace(SMOKES[arch_id], d_head=d_head)
    jp, model = _models(jcfg, seed=4)
    toks = _tokens(jcfg.vocab, 2, 24, seed=6)
    h_want, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(T.forward(model, torch.from_numpy(toks)).numpy(),
                               np.asarray(h_want), **FP32_TOL)
    np.testing.assert_allclose(T.prefill(model, torch.from_numpy(toks)).numpy(),
                               np.asarray(JT.prefill(jp, jnp.asarray(toks), jcfg)), **FP32_TOL)


def test_gemma3_smoke_prefill_bf16_matches_reference():
    """Gemma3 smoke in bf16 (local and global layers): logits within 0.1 of
    the reference's (6 layers of the two frameworks' bf16 rounding; TinyLlama's
    2 stay within 0.05; these differ by up to 0.0625 on 5 of 2,048) and the
    same argmax on most rows."""
    jcfg = dataclasses.replace(j_gemma.SMOKE, dtype=jnp.bfloat16)
    jp, model = _models(jcfg)
    toks = _tokens(jcfg.vocab, 8, 32)
    want = np.asarray(JT.prefill(jp, jnp.asarray(toks), jcfg))
    got = T.prefill(model, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).sum() >= 7


def test_moe_and_hybrid_trees_convert():
    """The reference's Qwen3 tree in bf16 carries across with its fp32
    router ((L, D, E)) and its stacked (L, E, D, F) experts unstacked per
    layer; a router in bf16, or an expert weight in fp32, is refused. The
    Gemma3 tree carries across too."""
    jcfg = dataclasses.replace(j_qwen.SMOKE, dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert tree["layers"]["mlp"]["router"].dtype == np.float32
    assert tree["layers"]["mlp"]["w_gate"].shape == (2, 8, 64, 32)
    cfg = _port_cfg(jcfg)
    model = convert.lm_params_from_numpy(tree, cfg, "cpu")
    mlp = model.layers[1].mlp
    assert isinstance(mlp, T.MoE)
    assert mlp.router.dtype == torch.float32 and mlp.w_gate.dtype == torch.bfloat16
    np.testing.assert_array_equal(mlp.router.numpy(), tree["layers"]["mlp"]["router"][1])
    np.testing.assert_array_equal(mlp.w_down.float().numpy(),
                                  tree["layers"]["mlp"]["w_down"][1].astype(np.float32))
    layers = tree["layers"]
    for bad, name in (({**layers["mlp"], "router": layers["mlp"]["router"].astype(
                            layers["mlp"]["w_up"].dtype)}, "router"),
                      ({**layers["mlp"], "w_up": layers["mlp"]["w_up"].astype(np.float32)},
                       "w_up")):
        with pytest.raises(ValueError, match=name):
            convert.lm_params_from_numpy({**tree, "layers": {**layers, "mlp": bad}}, cfg, "cpu")
    jp, model = _models(j_gemma.SMOKE)
    assert [b.attn.window for b in model.layers] == [8, 8, None, 8, 8, None]
    np.testing.assert_array_equal(model.layers[5].attn.wq.numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"][5]))


@pytest.mark.parametrize("arch_id", ["qwen3-moe-30b-a3b", "gemma3-12b", "deepseek-v3-671b"])
def test_serve_cli_moe_and_hybrid_archs(arch_id, capsys):
    """``serve --arch <arch> --smoke --device cpu``: the seeded model's
    greedy stream, the same as serve_lm on the model init_params draws."""
    run = serve.main(["--arch", arch_id, "--smoke", "--device", "cpu", "--tokens", "12",
                      "--batch", "2", "--max-len", "16"])
    assert run.tokens.shape == (2, 12)
    assert "tok/s" in capsys.readouterr().out
    model = T.init_params(configs.get_arch(arch_id).smoke_cfg, 0, "cpu")
    again = serve.serve_lm(model, batch=2, tokens=12, max_len=16)
    assert torch.equal(run.tokens, again.tokens)
