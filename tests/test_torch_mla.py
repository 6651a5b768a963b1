"""DeepSeek-V3's parts of the port on the CPU against live calls into repro:
MLA (``models/layers.py`` ``mla_forward``: the decompressed prefill and the
absorbed decode), the dense-FFN prefix and the MTP head's weights
(``models/transformer.py``), their trees (``models/convert.py``) and
``serve --arch deepseek-v3-671b --smoke``.

The reference's own weights (``init_mla``, ``init_params``, seed 0) are
carried across; inputs are numpy normals from a seed. The port's prefill
attention on the CPU is the flash kernel's plain version, the reference's
its chunked ``attention_full`` (``kv_chunk`` below S, so it scans). Two MLA
shapes: the smoke config's and DeepSeek's published head dims (dn = 128,
dr = 64, dv = 128: attention at dh = 192, dhv = 128) with 2 heads and narrow
ranks. Tolerances: 1e-5 in fp32 (the same sums in another order); in bf16
two ulps of the outputs' scale (2 x 2**-7 x their largest magnitude), as
the two frameworks round matmul accumulations at other places (measured:
one ulp in prefill, none in decode).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as j_deepseek
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
D = 64
THETA = 10000.0
MLAS = {
    "smoke": j_deepseek.SMOKE.mla,
    "published head dims": JL.MLAConfig(n_heads=2, q_lora_rank=32, kv_lora_rank=16,
                                        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
}
SMOKE_PARAMS = 253_760   # the reference's param_count of the smoke tree


def _port_mla(jm) -> L.MLAConfig:
    return L.MLAConfig(**dataclasses.asdict(jm))


def _port_cfg(jcfg, **over) -> T.LMConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.bfloat16 if jcfg.dtype == jnp.bfloat16 else torch.float32
    fields["moe"] = L.MoEConfig(**dataclasses.asdict(jcfg.moe))
    fields["mla"] = _port_mla(jcfg.mla)
    return T.LMConfig(**{**fields, **over})


def _tensor(a) -> torch.Tensor:
    """A jax or numpy array (bf16 included) as a CPU tensor, bits kept."""
    return convert.tensor_from_numpy(np.asarray(a), "cpu")


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _mla_params(jm, dtype=jnp.float32):
    jp = JL.init_mla(jax.random.PRNGKey(0), D, jm, dtype)
    return jp, {k: _tensor(v) for k, v in jp.items()}


def _close(got, want, dtype):
    """fp32: FP32_TOL; bf16: two ulps of the outputs' scale."""
    g, w = _f32(got), _f32(want)
    if dtype == jnp.float32:
        np.testing.assert_allclose(g, w, **FP32_TOL)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * 2 ** -7 * float(np.abs(w).max()))


def _prefill_case(jm, dtype, B=2, S=24, seed=0):
    """(port, reference) outputs of mla_forward without a cache; row 1's
    positions start at 7."""
    jp, tp = _mla_params(jm, dtype)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((B, S, D), dtype=np.float32),
                    dtype)
    pos = (np.arange(S)[None] + 7 * np.arange(B)[:, None]).astype(np.int32)
    got = L.mla_forward(tp, _tensor(x), torch.from_numpy(pos), _port_mla(jm), rope_theta=THETA)
    want = JL.mla_forward(jp, x, jnp.asarray(pos), jm, rope_theta=THETA, kv_chunk=8)
    return got, want


def _decode_steps(jm, dtype, steps=5, Smax=16, seed=1):
    """Absorbed decode, ``steps`` tokens a row from cache lengths 0, 3 and 9
    into random caches: yields (port out, reference out, port caches,
    reference caches) after each step. The port writes its caches in
    place; the reference returns new ones."""
    jp, tp = _mla_params(jm, dtype)
    rng = np.random.default_rng(seed)
    jkv = jnp.asarray(rng.standard_normal((3, Smax, jm.kv_lora_rank), dtype=np.float32), dtype)
    jkr = jnp.asarray(rng.standard_normal((3, Smax, jm.qk_rope_dim), dtype=np.float32), dtype)
    tkv, tkr = _tensor(jkv), _tensor(jkr)
    clen = np.array([0, 3, 9], np.int32)
    for _ in range(steps):
        x = jnp.asarray(rng.standard_normal((3, 1, D), dtype=np.float32), dtype)
        want, (jkv, jkr) = JL.mla_forward(jp, x, jnp.asarray(clen[:, None]), jm,
                                          rope_theta=THETA, cache=(jkv, jkr),
                                          cache_len=jnp.asarray(clen))
        got, (gkv, gkr) = L.mla_forward(tp, _tensor(x), torch.from_numpy(clen[:, None].copy()),
                                        _port_mla(jm), rope_theta=THETA, cache=(tkv, tkr),
                                        cache_len=torch.from_numpy(clen.copy()))
        assert gkv is tkv and gkr is tkr          # written in place
        yield got, want, (tkv, tkr), (jkv, jkr)
        clen = clen + 1


# -- MLA -----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MLAS))
def test_mla_prefill_matches_reference(name):
    """The decompressed prefill: output, latent and RoPE key, fp32."""
    (got, (gkv, gkr)), (want, (wkv, wkr)) = _prefill_case(MLAS[name], jnp.float32)
    m = MLAS[name]
    assert got.shape == (2, 24, D) and gkv.shape == (2, 24, m.kv_lora_rank)
    assert gkr.shape == (2, 24, m.qk_rope_dim)
    for a, b in ((got, want), (gkv, wkv), (gkr, wkr)):
        _close(a, b, jnp.float32)


@pytest.mark.parametrize("name", list(MLAS))
def test_mla_absorbed_decode_matches_reference(name):
    """Five absorbed-decode steps with rows at cache lengths 0, 3 and 9:
    each step's output and both caches, fp32."""
    for got, want, mine, theirs in _decode_steps(MLAS[name], jnp.float32):
        _close(got, want, jnp.float32)
        for a, b in zip(mine, theirs):
            _close(a, b, jnp.float32)


@pytest.mark.parametrize("name", list(MLAS))
def test_mla_absorbed_decode_equals_prefill(name):
    """The port alone: token by token through the absorbed decode gives the
    decompressed prefill's output at every position, and fills the caches
    with its latent and RoPE key, fp32."""
    jm = MLAS[name]
    _, tp = _mla_params(jm)
    B, S = 2, 12
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, S, D), dtype=np.float32))
    pos = torch.arange(S).expand(B, S)
    full, (kv_c, k_rope) = L.mla_forward(tp, x, pos, _port_mla(jm), rope_theta=THETA)
    caches = (torch.zeros((B, S, jm.kv_lora_rank)), torch.zeros((B, S, jm.qk_rope_dim)))
    steps = []
    for t in range(S):
        clen = torch.full((B,), t, dtype=torch.int32)
        out, _ = L.mla_forward(tp, x[:, t:t + 1], clen[:, None], _port_mla(jm),
                               rope_theta=THETA, cache=caches, cache_len=clen)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), **FP32_TOL)
    np.testing.assert_allclose(caches[0].numpy(), kv_c.numpy(), **FP32_TOL)
    np.testing.assert_allclose(caches[1].numpy(), k_rope.numpy(), **FP32_TOL)


@pytest.mark.parametrize("stage", ["prefill", "decode"])
def test_mla_bf16_matches_reference(stage):
    """The smoke MLA in bf16: outputs (and the decode's caches) within two
    ulps of their scale; q_abs and the latent output round to bf16 where
    the reference casts them."""
    jm = MLAS["smoke"]
    if stage == "prefill":
        (got, caches), (want, jcaches) = _prefill_case(jm, jnp.bfloat16)
        assert got.dtype == torch.bfloat16
        _close(got, want, jnp.bfloat16)
        for a, b in zip(caches, jcaches):
            _close(a, b, jnp.bfloat16)
        return
    for got, want, mine, theirs in _decode_steps(jm, jnp.bfloat16):
        assert got.dtype == mine[0].dtype == torch.bfloat16
        _close(got, want, jnp.bfloat16)
        for a, b in zip(mine, theirs):
            _close(a, b, jnp.bfloat16)


def test_mla_decode_takes_one_token():
    jm = MLAS["smoke"]
    _, tp = _mla_params(jm)
    caches = (torch.zeros((1, 8, jm.kv_lora_rank)), torch.zeros((1, 8, jm.qk_rope_dim)))
    with pytest.raises(ValueError, match="one token"):
        L.mla_forward(tp, torch.zeros((1, 2, D)), torch.zeros((1, 2), dtype=torch.int32),
                      _port_mla(jm), rope_theta=THETA, cache=caches,
                      cache_len=torch.zeros(1, dtype=torch.int32))


# -- the tree: prefix, stacked layers, MTP ------------------------------------


def _tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(seed), jcfg))


def test_deepseek_tree_converts_bit_for_bit():
    """The reference's bf16 smoke tree: ``prefix`` a list of one dense layer,
    ``layers`` stacked over n_scan_layers = 2 (MLA + MoE, the router fp32),
    ``mtp`` a proj, a dense MLA block and a norm; every leaf lands on the
    port's parameter of the same name bit for bit."""
    jcfg = dataclasses.replace(j_deepseek.SMOKE, dtype=jnp.bfloat16)
    tree = _tree(jcfg)
    assert isinstance(tree["prefix"], list) and len(tree["prefix"]) == 1
    assert tree["layers"]["attn"]["w_uk"].shape[0] == jcfg.n_scan_layers == 2
    assert "router" not in tree["prefix"][0]["mlp"] and "router" not in tree["mtp"]["layer"]["mlp"]
    model = convert.lm_params_from_numpy(tree, _port_cfg(jcfg), "cpu")
    named = dict(model.named_parameters())
    flat = convert._flatten(tree)
    for name, a in flat.items():
        if name.startswith("layers."):
            _, rest = name.split(".", 1)
            pairs = [(f"layers.{i}.{rest}", a[i]) for i in range(a.shape[0])]
        else:
            pairs = [(name, a)]
        for port_name, want in pairs:
            got = named[port_name]
            if want.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16, port_name
                got, want = got.view(torch.int16), np.asarray(want).view(np.int16)
            else:
                assert got.dtype == torch.float32, port_name
            np.testing.assert_array_equal(got.numpy(), want, err_msg=port_name)
    assert sum(n.startswith("mtp.") for n in named) == sum(n.startswith("mtp.") for n in flat)
    assert isinstance(model.prefix[0].mlp, T.SwiGLU) and isinstance(model.layers[0].mlp, T.MoE)
    assert model.layers[1].mlp.router.dtype == torch.float32


def test_deepseek_tree_refusals_name_the_leaf():
    """A tree whose ``layers`` are stacked over n_layers (3), not
    n_scan_layers (2), or one without ``mtp.proj``, is refused by name."""
    jcfg = j_deepseek.SMOKE
    tree = _tree(jcfg)
    cfg = _port_cfg(jcfg)
    three = jax.tree.map(lambda a: np.concatenate([a[:1], a]), tree["layers"])
    with pytest.raises(ValueError, match=r"layers\..*does not have 2 layers"):
        convert.lm_params_from_numpy({**tree, "layers": three}, cfg, "cpu")
    no_proj = {k: v for k, v in tree["mtp"].items() if k != "proj"}
    with pytest.raises(ValueError, match=r"missing \['mtp.proj'\]"):
        convert.lm_params_from_numpy({**tree, "mtp": no_proj}, cfg, "cpu")
    no_prefix = {k: v for k, v in tree.items() if k != "prefix"}
    with pytest.raises(ValueError, match=r"prefix\.0\.attn"):
        convert.lm_params_from_numpy(no_prefix, cfg, "cpu")


def test_deepseek_smoke_param_count_is_the_reference():
    """The smoke model's parameters, drawn by the port or carried, count
    what the reference's tree holds (MTP included)."""
    jcfg = j_deepseek.SMOKE
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    assert JT.param_count(jp) == SMOKE_PARAMS
    carried = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), _port_cfg(jcfg), "cpu")
    drawn = T.init_params(configs.get_arch("deepseek-v3-671b").smoke_cfg, 0, "cpu")
    assert T.param_count(carried) == T.param_count(drawn) == SMOKE_PARAMS
    mtp = sum(p.numel() for n, p in drawn.named_parameters() if n.startswith("mtp."))
    assert mtp == sum(np.asarray(a).size for a in jax.tree.leaves(jp["mtp"]))


def test_serve_cli_deepseek_smoke_emits_the_reference_stream(monkeypatch, capsys):
    """``serve --arch deepseek-v3-671b --smoke --device cpu`` with the
    reference's weights in place of the port's draws: the greedy stream is
    the reference's decode_step loop's, token for token."""
    jcfg = j_deepseek.SMOKE
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    carried = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), _port_cfg(jcfg), "cpu")
    smoke = configs.get_arch("deepseek-v3-671b").smoke_cfg

    def init_params(cfg, seed, device):
        assert cfg == smoke and seed == 0 and str(device) == "cpu"
        return carried
    monkeypatch.setattr(serve.tf, "init_params", init_params)
    B, steps, max_len = 2, 12, 16
    run = serve.main(["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
                      "--tokens", str(steps), "--batch", str(B), "--max-len", str(max_len)])
    assert "tok/s" in capsys.readouterr().out
    caches = JT.init_cache(jcfg, B, max_len)
    step = jax.jit(lambda p, t, pos, c: JT.decode_step(p, t, pos, c, jcfg))
    tok, want = jnp.zeros(B, jnp.int32), []
    for t in range(steps):
        logits, caches = step(jp, tok, jnp.full((B,), t, jnp.int32), caches)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
    np.testing.assert_array_equal(run.tokens.numpy(), np.stack(want, 1))
