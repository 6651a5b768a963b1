"""The port's LM training slice on the CPU against live calls into repro.

For each of the five smoke configs (dense GQA, sliding window, Qwen3's
MoE, Gemma3's local:global pattern, DeepSeek's MLA with its dense prefix
and MTP head), in fp32, the reference's own weights carried across by
``models/convert.py`` and one numpy batch (labels with -100s) go through
``repro.models.transformer.loss_fn`` and ``repro_torch.models.transformer.
loss_fn``: loss, nll and aux, every parameter's gradient (``jax.grad``
against ``torch.autograd``, carried back by name), and three train steps
with the arch's optimizer (the reference's jitted ``make_train_step``).
The attention backward alone is ``tests/test_torch_attention_bwd.py``.

Tolerances: losses rtol 1e-5 (fp32, the two differ in summation order);
each gradient within 1e-5 of its own max-abs (tighter than the 1e-4 asked
of it). After three
optimizer steps parameters agree within 5e-6 absolute, except an element
whose gradient sat within that gradient tolerance of 0 at some step: there
AdamW's g / (|g| + eps) (a 5e-8 gradient against the reference's 7e-8
gives 0.83 against 0.88) and Adafactor's normalised update are
ill-conditioned, so such an element is held within 2 x lr a step (lr =
3e-4 AdamW, 1e-3 Adafactor), the most an update of RMS <= 1 can move it.
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
from repro.models import transformer as JT
from repro.train import optimizer as j_opt
from repro.train import train_loop as j_loop
from repro_torch import configs
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_loop import make_train_step, trainable
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

JMODS = {"tinyllama-1.1b": j_tiny, "h2o-danube-1.8b": j_danube,
         "qwen3-moe-30b-a3b": j_qwen, "gemma3-12b": j_gemma,
         "deepseek-v3-671b": j_deepseek}
LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
PARAM_ATOL = 5e-6
B, S = 2, 16


def _port_cfg(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["dtype"] = torch.bfloat16 if jcfg.dtype == jnp.bfloat16 else torch.float32
    if jcfg.moe is not None:
        fields["moe"] = L.MoEConfig(**dataclasses.asdict(jcfg.moe))
    if jcfg.mla is not None:
        fields["mla"] = L.MLAConfig(**dataclasses.asdict(jcfg.mla))
    return T.LMConfig(**{**fields, **over})


def _batch(vocab, seed=3):
    """Tokens from a seed; labels shifted left, -100 at each row's end and
    at two more places (ignored positions inside the sequence)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    labels[0, 3] = labels[1, 9] = -100
    return {"tokens": toks, "labels": labels}


def _setup(arch_id, **over):
    jcfg = dataclasses.replace(JMODS[arch_id].SMOKE, **over)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), _port_cfg(jcfg), "cpu")
    nb = _batch(jcfg.vocab)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    return jcfg, jp, model, jb, tb


def _by_name(tree, n_scan):
    """A reference tree (params or grads) as {port parameter name: numpy}."""
    out = {}
    for name, a in convert._flatten(jax.tree.map(np.asarray, tree)).items():
        if name.startswith("layers."):
            rest = name.split(".", 1)[1]
            out.update({f"layers.{i}.{rest}": a[i] for i in range(n_scan)})
        else:
            out[name] = a
    return out


def _port_grads(model, batch):
    named = trainable(model)
    loss, metrics = T.loss_fn(model, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, metrics, dict(zip(named, grads))


def _close_by_max(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max abs error {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("arch_id", list(JMODS))
def test_loss_and_every_gradient_match_the_reference(arch_id):
    jcfg, jp, model, jb, tb = _setup(arch_id)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True)(jp)
    loss, metrics, grads = _port_grads(model, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]), rtol=LOSS_RTOL,
                               atol=1e-12)
    if jcfg.moe is not None:
        assert float(metrics["aux"]) > 0.0
    want = _by_name(jgrads, jcfg.n_layers - jcfg.n_dense_prefix)
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        _close_by_max(g.numpy(), want[name], GRAD_REL, f"{arch_id} grad {name}")
    # the MTP head and the experts are reached (not silently cut off)
    if jcfg.mtp:
        assert float(grads["mtp.proj"].abs().max()) > 0.0
    for name in ("wq", "wk", "wv", "w_uq", "w_uk", "w_uv", "w_kr"):
        key = f"layers.0.attn.{name}"
        if key in grads:
            assert float(grads[key].abs().max()) > 0.0, key


@pytest.mark.parametrize("arch_id", list(JMODS))
def test_three_train_steps_match_the_reference(arch_id):
    """The arch's optimizer at the reference's defaults: three steps of the
    port's ``make_train_step`` against the reference's jitted one."""
    jcfg, jp, model, jb, tb = _setup(arch_id)
    opt = configs.get_arch(arch_id).optimizer
    j_init, j_update = j_opt.make_optimizer(opt)
    j_step = jax.jit(j_loop.make_train_step(lambda p, b: JT.loss_fn(p, b, jcfg), j_update))
    init, update = make_optimizer(opt)
    small = {}

    def update_spying(grads, st, params):
        for n, g in grads.items():
            near0 = g.abs() <= GRAD_REL * g.abs().max()
            small[n] = small[n] | near0 if n in small else near0
        return update(grads, st, params)

    step = make_train_step(T.loss_fn, update_spying)
    js, state = j_init(jp), init(trainable(model))
    for _ in range(3):
        jp, js, jmet = j_step(jp, js, jb)
        _, state, met = step(model, state, tb)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
        if "grad_norm" in jmet:
            np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                                       rtol=1e-5)
    assert int(state["step"]) == 3
    want = _by_name(jp, jcfg.n_layers - jcfg.n_dense_prefix)
    lr = {"adamw": 3e-4, "adafactor": 1e-3}[opt]
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name])
        near0 = small[name].numpy()
        assert diff[~near0].max(initial=0.0) <= PARAM_ATOL, f"{arch_id} {name}"
        assert diff[near0].max(initial=0.0) <= 2 * lr * 3, f"{arch_id} {name} (grad ~ 0)"
    if opt == "adafactor":   # the state is the reference's tree, leaf by leaf
        for part in ("vr", "vc"):
            jstate = convert._flatten(jax.tree.map(np.asarray, getattr(js, part)))
            assert jstate.keys() == state[part].keys()
            for key, a in state[part].items():
                np.testing.assert_allclose(a.numpy(), jstate[key], rtol=1e-4, atol=1e-12,
                                           err_msg=f"{arch_id} {part} {key}")


@pytest.mark.parametrize("arch_id", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_remat_gives_the_same_loss_and_gradients(arch_id):
    _, _, model, _, tb = _setup(arch_id)
    loss, _, grads = _port_grads(model, tb)
    _, _, remat_model, _, _ = _setup(arch_id, remat=True)
    assert remat_model.cfg.remat
    rloss, _, rgrads = _port_grads(remat_model, tb)
    assert float(rloss) == float(loss)
    for name, g in grads.items():
        torch.testing.assert_close(rgrads[name], g, rtol=1e-6, atol=1e-7)


def test_serving_entry_points_stay_frozen_and_gradient_free():
    """Training turns the weights on; ``prefill`` still runs under
    inference mode (no graph, the same logits)."""
    _, _, model, _, tb = _setup("tinyllama-1.1b")
    before = T.prefill(model, tb["tokens"])
    assert not any(p.requires_grad for p in model.parameters())
    trainable(model)
    after = T.prefill(model, tb["tokens"])
    assert after.grad_fn is None and torch.equal(before, after)
