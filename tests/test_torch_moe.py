"""The port's MoE family (phi3.5-moe, qwen3-moe with QK-norm) vs the JAX
reference, on the CPU at reduced sizes.

The same seeded numpy inputs go through ``repro.models.moe.moe_block`` and
``repro_torch.models.moe.MoE``, through QK-norm attention, through whole
reduced models (prefill, decode, the serve engine) and through ``lm_loss``
with its gradients. The whole-model helpers are those of
``test_torch_models.py``, ``test_torch_serve.py`` and ``test_torch_train.py``.

Tolerances, all fp32:
  * the MoE block and attention: 1e-5 (only the order of sums differs; the
    port gathers where the reference sums one-hot products, and its combine
    adds the k gated rows in another order; about 2.4e-7 is seen);
  * the aux loss: 1e-5 relative;
  * gradients of one block: 1e-5 of each leaf's largest; the gates' gradient
    is rounded to bf16 on both sides (the reference's bf16 combine, the
    port's bf16 cast), so a sum that lands within fp32 noise of a bf16
    rounding boundary could round apart; none does here;
  * whole models: the tolerances of the files whose helpers they use (2e-4
    on logits, 1e-5 on the loss, 2e-5 of each leaf's largest gradient).
Routing is exact on both sides: the same choices, queue positions and
drops, which the tight-capacity cases check through the rows they zero.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattention
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.common import KeyGen
from repro.parallel import sharding as jshd
from repro_torch.configs import ARCHS
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe
from repro_torch.models.attention import Attention, init_kv_cache
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import LM
from repro_torch.parallel import sharding as shd

from test_torch_models import LOGIT_TOL, _reference
from test_torch_parallel import MESHES, _by_port_name
from test_torch_serve import PROMPTS, _engines
from test_torch_train import (GRAD_TOL, LOSS_TOL, _assert_grads_close, _batch,
                              _port_loss_and_grads, _reference_loss_and_grads, _setup,
                              _two_threads)  # noqa: F401 (autouse fixture)

OP_TOL = 1e-5
MOE = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _cfgs(name, E=None, k=None, cap=None, d=None, ff=None):
    """(port config, reference config): the reduced ``name`` with the MoE
    fields of ``tests/test_moe.py``'s cases replaced where given."""
    kw = {key: val for key, val in dict(n_experts=E, experts_per_token=k,
                                        moe_capacity_factor=cap, d_model=d,
                                        d_ff=ff).items() if val is not None}
    return (dataclasses.replace(ARCHS[name].reduced(), **kw),
            dataclasses.replace(JARCHS[name].reduced(), **kw))


def _block_pair(cfg, jcfg, seed=0):
    """The reference's MoE init and a port MoE loaded from it."""
    p = jmoe.init_moe(KeyGen(jax.random.PRNGKey(seed)), jcfg, jnp.float32)
    m = moe.MoE(cfg, "cpu", torch.float32)
    m.load_state_dict({k: _t(v) for k, v in p.items()})
    return p, m


def _zero_rows(out):
    return np.all(np.abs(np.asarray(out)) < 1e-9, axis=-1)


# ---------------------------------------------------------------------------
# The MoE block
# ---------------------------------------------------------------------------

# tests/test_moe.py's cases, and the model's own group size over token counts
# it divides and does not divide:
#   id: (E, k, capacity factor, d, ff, x shape, group_size)
BLOCK_CASES = {
    "shape_and_finite": (8, 2, 8.0, 32, 64, (2, 16, 32), 16),
    "nodrop": (4, 2, 2.0, 32, 64, (1, 8, 32), 8),
    "capacity_full": (4, 1, 4.0, 32, 64, (1, 32, 32), 32),
    "capacity_tight": (4, 1, 0.1, 32, 64, (1, 32, 32), 32),
    "primary_priority": (2, 2, 0.5, 32, 64, (1, 16, 32), 16),
    "reduced_group_divides": (None, None, None, None, None, (2, 24, 64), 256),
    "reduced_group_lowered": (None, None, None, None, None, (3, 17, 64), 8),  # g = 3
    "reduced_tight_lowered": (None, None, 0.3, None, None, (2, 35, 64), 16),  # g = 14
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
@pytest.mark.parametrize("name", MOE)
def test_moe_block_matches_reference(name, case):
    E, k, cap, d, ff, shape, group_size = BLOCK_CASES[case]
    cfg, jcfg = _cfgs(name, E, k, cap, d, ff)
    p, m = _block_pair(cfg, jcfg)
    x = np.random.default_rng(len(case)).standard_normal(shape).astype(np.float32)
    want, want_aux = jmoe.moe_block(p, jcfg, jnp.asarray(x), group_size=group_size)
    with torch.no_grad():
        out, aux = m(_t(x), group_size=group_size)
    assert out.shape == x.shape and aux.dtype == torch.float32
    _close(out, want, OP_TOL)
    assert abs(float(aux) - float(want_aux)) <= OP_TOL * abs(float(want_aux))
    assert float(aux) > 0
    # the same tokens lost every choice to capacity
    np.testing.assert_array_equal(_zero_rows(out.numpy()), _zero_rows(want))
    if case == "capacity_tight":
        assert _zero_rows(out.numpy()).mean() > 0.5


@pytest.mark.parametrize("g,E,seed", [(8, 2, 0), (16, 4, 3), (32, 8, 5)])
def test_moe_aux_loss_matches_reference_within_its_bounds(g, E, seed):
    """tests/test_moe.py's aux bounds (1 at balance, E at collapse), on both."""
    cfg, jcfg = _cfgs(MOE[0], E, 1, 1.25, 32, 64)
    p, m = _block_pair(cfg, jcfg, seed)
    x = np.random.default_rng(seed).standard_normal((1, g, 32)).astype(np.float32)
    _, want = jmoe.moe_block(p, jcfg, jnp.asarray(x), group_size=g)
    with torch.no_grad():
        _, aux = m(_t(x), group_size=g)
    assert abs(float(aux) - float(want)) <= OP_TOL * float(want)
    assert 0.5 <= float(aux) <= E + 1e-3


def test_moe_ties_go_to_the_lower_expert_index():
    """A zero router gives every expert the same probability: ``jax.lax.top_k``
    then takes experts 0..k-1, in that order, and so must the port; with all
    tokens on two experts, capacity drops the later tokens' second choices."""
    cfg, jcfg = _cfgs(MOE[1], 8, 2, 1.25, 32, 64)
    p, m = _block_pair(cfg, jcfg)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    with torch.no_grad():
        m.router.zero_()
    x = np.random.default_rng(9).standard_normal((2, 16, 32)).astype(np.float32)
    want, _ = jmoe.moe_block(p, jcfg, jnp.asarray(x))
    with torch.no_grad():
        out, _ = m(_t(x))
    _close(out, want, OP_TOL)
    # one group of 32 tokens, C = ceil(32 * 2 / 8 * 1.25) = 10: expert 0 (every
    # first choice) and expert 1 (every second) each keep tokens 0-9
    assert _zero_rows(out.numpy()).reshape(-1).sum() == 32 - 10


def test_moe_block_gradients_match_reference():
    """x, router and expert weight gradients of a weighted sum of the output
    plus the aux loss, at a capacity that drops choices."""
    cfg, jcfg = _cfgs(MOE[1], cap=0.6)
    p, m = _block_pair(cfg, jcfg, seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_block(p, jcfg, x)
        return jnp.sum(out * w) + 3.0 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    m.requires_grad_(True)
    tx = _t(x).requires_grad_()
    out, aux = m(tx)
    loss = (out * _t(w)).sum() + 3.0 * aux
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(loss, (tx,) + params)
    for name, got, want in zip(("x",) + names, grads, (jgx,) + tuple(jgp[n] for n in names)):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0, name
        np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL * np.abs(want).max(),
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# QK-norm attention
# ---------------------------------------------------------------------------

def test_qk_norm_attention_matches_reference():
    """qwen3's per-head RMSNorm of q and k (after the bias, before RoPE) in
    forward, prefill and decode, with nonzero norm scales."""
    cfg = ARCHS[MOE[1]].reduced()
    assert cfg.qk_norm
    jp = jattention.init_attention(KeyGen(jax.random.PRNGKey(4)), cfg, jnp.float32)
    rng = np.random.default_rng(4)
    jp = dict(jp, q_norm=jnp.asarray(rng.standard_normal(cfg.head_dim) * 0.3, jnp.float32),
              k_norm=jnp.asarray(rng.standard_normal(cfg.head_dim) * 0.3, jnp.float32))
    mod = Attention(cfg, "cpu", torch.float32, local=False)
    mod.load_state_dict({k: _t(v) for k, v in jp.items()})
    assert sorted(dict(mod.named_parameters())) == sorted(jp)
    S = 21
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = jattention.attention_block(jp, cfg, jnp.asarray(x), jnp.arange(S),
                                      backend="reference")
    with torch.no_grad():
        _close(mod(_t(x), torch.arange(S)), want, OP_TOL)
        cache = init_kv_cache(cfg, 2, 32, torch.float32, "cpu")
        _close(mod.prefill(_t(x), torch.arange(S), cache), want, OP_TOL)
    jcache = jattention.init_kv_cache(cfg, 2, 32, jnp.float32)
    jstep = jax.jit(functools.partial(jattention.decode_attention_block, jp, cfg))
    with torch.no_grad():
        cache = init_kv_cache(cfg, 2, 32, torch.float32, "cpu")
        for pos in range(6):
            xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            jout, jcache = jstep(jnp.asarray(xt), jnp.asarray(pos, jnp.int32), jcache)
            _close(mod.decode(_t(xt), pos, cache), jout, OP_TOL)
    _close(cache["k"], jcache["k"], OP_TOL)
    # without the norm the output differs: the test sees it
    plain = dataclasses.replace(cfg, qk_norm=False)
    assert not np.allclose(np.asarray(want), np.asarray(jattention.attention_block(
        {k: v for k, v in jp.items() if "norm" not in k}, plain, jnp.asarray(x),
        jnp.arange(S), backend="reference")), atol=1e-3)


# ---------------------------------------------------------------------------
# Parameters: names, shapes, specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_from_jax_params_loads_expert_leaves_by_layer(name):
    """``params["blocks"][i]["moe"][leaf][g]`` is ``layers.{g*p+i}.moe.<leaf>``."""
    jcfg, _, _, np_params, lm = _reference(name)
    n_groups, _ = jcfg.n_groups_and_tail()
    p = len(jcfg.mixer_pattern)
    sd = lm.state_dict()
    leaves = ["router", "w_up", "w_down", "w_gate"]
    for i, blk in enumerate(np_params["blocks"]):
        assert sorted(blk["moe"]) == sorted(leaves) and "mlp" not in blk
        for g in range(n_groups):
            for leaf in leaves:
                np.testing.assert_array_equal(sd[f"layers.{g * p + i}.moe.{leaf}"].numpy(),
                                              blk["moe"][leaf][g])
            if jcfg.qk_norm:
                np.testing.assert_array_equal(sd[f"layers.{g * p + i}.attn.q_norm"].numpy(),
                                              blk["attn"]["q_norm"][g])
    assert not any(".mlp." in n for n in sd)


@pytest.mark.parametrize("name", MOE)
def test_full_width_moe_on_meta_device(name):
    """Full width without allocating: the reference's leaf shapes, layer by
    layer, and the footprint that sets the card runs' depth."""
    cfg, jcfg = ARCHS[name], JARCHS[name]
    lm = LM(cfg, torch.device("meta"), torch.bfloat16)
    shapes = jax.eval_shape(lambda k: jtransformer.init_lm_params(jcfg, k, jnp.bfloat16),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    got = {n: tuple(t.shape) for n, t in lm.named_parameters()}
    blk = shapes["blocks"][0]
    for leaf, s in blk["moe"].items():
        assert got[f"layers.0.moe.{leaf}"] == tuple(s.shape[1:])
        assert got[f"layers.{cfg.n_layers - 1}.moe.{leaf}"] == tuple(s.shape[1:])
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    per_layer = sum(int(np.prod(s)) for k, s in got.items() if k.startswith("layers.0."))
    outer = sum(int(np.prod(s)) for k, s in got.items() if not k.startswith("layers."))
    if name == "qwen3-moe-235b-a22b":
        assert got["layers.0.attn.q_norm"] == (128,)
        assert 2.4e9 < per_layer < 2.5e9 and 1.24e9 < outer < 1.25e9
        assert 2 * (8 * per_layer + outer) < 45e9 < 2 * n  # 8 layers fit 80 GB, 94 do not
    else:
        assert "layers.0.attn.q_norm" not in got and "layers.0.norm1.g" in got
        assert 1.29e9 < per_layer < 1.31e9


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", MOE)
def test_moe_param_specs_match_reference(name, full):
    """Every strategy: each unstacked [E, d, ff] leaf of the port resolves to
    the reference's stacked [G, E, d, ff] spec minus its leading ``layers``
    entry, as does every other leaf; the router's logical axes are
    ("embed", None)."""
    cfg, jcfg = (ARCHS[name], JARCHS[name]) if full else (ARCHS[name].reduced(),
                                                         JARCHS[name].reduced())
    jshapes = jax.eval_shape(lambda k: jtransformer.init_lm_params(jcfg, k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    lm = LM(cfg, torch.device("meta"), torch.float32)
    assert shd.logical_for_leaf("router", 2) == ("embed", None)
    assert shd.logical_for_leaf("w_up", 3) == ("experts", "embed", "ff")
    assert shd.logical_for_leaf("w_down", 3) == ("experts", "ff", "embed")
    for shape, axes in MESHES.items():
        amesh, sizes = AbstractMesh(shape, axes), dict(zip(axes, shape))
        for strategy in jshd.STRATEGIES:
            rules = jshd.STRATEGIES[strategy]()
            stacked, sharded_lead = _by_port_name(
                cfg, jshd.param_specs(amesh, rules, jshapes), PartitionSpec)
            assert not sharded_lead, (shape, strategy)
            got = shd.param_specs(sizes, rules, lm)
            assert got == stacked, (shape, strategy)
            router = jshd.resolve_spec(amesh, rules, ("embed", None), (cfg.d_model,
                                                                       cfg.n_experts))
            assert got["layers.0.moe.router"] == tuple(router), (shape, strategy)


# ---------------------------------------------------------------------------
# Whole models: serving and training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
def test_model_prefill_and_decode_match_reference(name):
    """Prefill 30 tokens, then 3 greedy decode steps (B 2: C = 1 in decode):
    logits within 2e-4 and the same greedy tokens."""
    jcfg, jmodel, jparams, _, lm = _reference(name)
    model = build_model(ARCHS[name].reduced(), device="cpu")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 30))
    jcache = jmodel.init_cache(2, max_len=40, dtype=jnp.float32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, {"tokens": jnp.asarray(toks)}, jcache)
    jdecode = jax.jit(jmodel.decode_step)
    cache = model.init_cache(2, 40, torch.float32)
    with torch.inference_mode():
        logits, cache = model.prefill(lm, {"tokens": torch.from_numpy(toks)}, cache)
        for _ in range(3):
            _close(logits, jlogits, LOGIT_TOL)
            tok = np.asarray(jnp.argmax(jlogits, -1))
            np.testing.assert_array_equal(logits.argmax(-1).numpy(), tok)
            jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
            logits, cache = model.decode_step(lm, cache, torch.from_numpy(np.array(tok)))
        _close(logits, jlogits, LOGIT_TOL)
    assert cache["pos"] == 33


@pytest.mark.parametrize("name", MOE)
def test_greedy_tokens_match_the_reference_engine(name):
    """Ragged prompts, left-padded: the padding routes and takes capacity as
    any token does, on both sides."""
    jeng, eng = _engines(name)
    want = jeng.generate(PROMPTS)
    assert eng.generate(PROMPTS) == want
    assert eng.last_timing["prefill_len"] == 12


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("name", MOE)
def test_lm_loss_and_every_gradient_match_reference(name, policy):
    """The loss with its aux term, ``moe_aux``, and every leaf's gradient (the
    routers' too) under ``policy`` on both sides."""
    cfg, jmodel, np_params = _setup(name)
    batch = _batch(cfg, mask=(name == MOE[0]))
    loss, metrics, grads = _port_loss_and_grads(cfg, np_params, batch, remat_policy=policy)
    want_loss, want_grads, want_metrics = _reference_loss_and_grads(
        cfg, jmodel, np_params, batch, remat_policy=policy)
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    aux = float(metrics["moe_aux"].detach())
    assert aux > 1.0
    assert abs(aux - want_metrics["moe_aux"]) <= LOSS_TOL * want_metrics["moe_aux"]
    routers = [n for n in want_grads if n.endswith("moe.router")]
    assert len(routers) == cfg.n_layers
    assert all(float(want_grads[n].abs().max()) > 0 for n in routers)
    _assert_grads_close(grads, want_grads, GRAD_TOL)


@pytest.mark.parametrize("name", MOE)
def test_launch_serve_runs_moe_on_cpu(name, capsys):
    res = launch_serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
                             "--prompt-len", "20", "--min-prompt-len", "9", "--max-len", "32",
                             "--max-new", "3"])
    assert [len(o) for o in res["outputs"]] == [3, 3]
    assert res["cfg"].is_moe and res["dtype"] == "float32"
    assert res["timing"]["prefill_len"] == max(len(p) for p in res["prompts"])
    assert "generated 6 tokens" in capsys.readouterr().out
