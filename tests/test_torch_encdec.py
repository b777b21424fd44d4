"""The port's encoder-decoder (whisper-medium) vs the JAX reference, on the
CPU at the reduced size (2 + 2 layers, d 64, 4 heads, 2 KV heads in
self-attention and 4 in cross-attention, head_dim 16).

Parameters are drawn with numpy in ``repro.models.encdec``'s pytree layout
(the layout from ``eval_shape`` of its init, nothing compiled; each LayerNorm
gain near 1) and carried across with ``from_jax_params``; the frames and
tokens are seeded numpy arrays. Both sides run in fp32; the reference's
attention takes its jnp path on the CPU (``backend="auto"``).

Tolerances, all fp32 (the order of sums is all that differs):
  * one attention layer: 1e-5;
  * memory and logits after the whole model: 2e-4, as the other parity
    files hold whole-model logits;
  * the loss within 1e-5 of itself and each parameter's gradient within
    2e-5 of the largest magnitude of the reference's gradient for that
    parameter, the tolerances of ``test_torch_train.py``;
  * a ``train_loop`` loss within 1e-4 of itself, as ``test_torch_train.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Shard

from repro.configs import ARCHS as JARCHS
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models.model_zoo import build_model as jbuild_model
from repro.train import optimizer as joptim
from repro.train.train_loop import TrainRunConfig as JTrainRunConfig
from repro.train.train_loop import train_loop as jtrain_loop
from repro_torch.configs import ARCHS
from repro_torch.models.attention import Attention
from repro_torch.models.encdec import EncDec
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.parallel.sharding import STRATEGIES
from repro_torch.train import optimizer
from repro_torch.train.train_loop import TrainRunConfig, train_loop
from repro_torch.weights import from_jax_params, init_params, jax_params_to_state_dict

from test_torch_launch import _mesh
from test_torch_train import GRAD_TOL, LOSS_TOL, _assert_grads_close

NAME = "whisper-medium"
OP_TOL = 1e-5
LOGIT_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _numpy_params(jcfg, seed):
    """``init_encdec_params``' layout filled with seeded normals: 0.05 for
    matrices, 0.1 for vectors, LayerNorm gains 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(lambda k: jencdec.init_encdec_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        lead = 1 if path[0].key in ("enc_blocks", "dec_blocks") else 0
        x = rng.standard_normal(s.shape) * (0.05 if len(s.shape) - lead > 1 else 0.1)
        return (x + (path[-1].key == "g")).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _reference():
    """(jax config, jax model, jax params, numpy params, port EncDec)."""
    jcfg = JARCHS[NAME].reduced()
    np_params = _numpy_params(jcfg, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = from_jax_params(ARCHS[NAME].reduced(), np_params, device="cpu")
    return jcfg, jbuild_model(jcfg), jparams, np_params, model


def _inputs(cfg, B=2, T=20, S=12, seed=1):
    """frames [B, T, d] (T 20 against the 16-row enc_pos: positions tile),
    tokens and labels [B, S]."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_grads_close_key_bias_apart(got, want, tol):
    """``_assert_grads_close`` on every leaf but the key biases. A key bias's
    gradient is 0 exactly (it shifts a query's scores by the same amount for
    every key, which softmax does not see), so both sides hold rounding
    noise; each side's must lie within ``tol`` of the largest gradient of
    the same layer's ``wk``."""
    zero = [n for n in want if n.endswith(".bk")]
    assert zero and sorted(got) == sorted(want)
    for n in zero:
        scale = float(want[n[:-2] + "wk"].abs().max())
        assert max(float(got[n].abs().max()), float(want[n].abs().max())) <= tol * scale, n
    _assert_grads_close({n: g for n, g in got.items() if n not in zero},
                        {n: g for n, g in want.items() if n not in zero}, tol)


# ---------------------------------------------------------------------------
# Attention: cross-attention and no RoPE
# ---------------------------------------------------------------------------

def test_cross_attention_has_as_many_kv_heads_as_query_heads():
    cfg = ARCHS[NAME].reduced()
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)
    self_attn = Attention(cfg, "meta", torch.float32)
    cross = Attention(cfg, "meta", torch.float32, cross=True)
    assert tuple(self_attn.wk.shape) == (64, 2, 16) and tuple(self_attn.bv.shape) == (2, 16)
    assert tuple(cross.wk.shape) == (64, 4, 16) and tuple(cross.wv.shape) == (64, 4, 16)
    assert tuple(cross.bk.shape) == (4, 16) and tuple(cross.wq.shape) == (64, 4, 16)
    full = Attention(ARCHS[NAME], "meta", torch.bfloat16, cross=True)
    assert tuple(full.wk.shape) == (1024, 16, 64)
    with pytest.raises(ValueError, match="memory"):
        cross(torch.zeros(1, 3, 64), torch.arange(3))
    with pytest.raises(ValueError, match="memory"):
        Attention(cfg, "cpu", torch.float32)(torch.zeros(1, 3, 64), torch.arange(3),
                                             memory=torch.zeros(1, 5, 64))


@pytest.mark.parametrize("kind", ["encoder", "decoder", "cross"])
def test_attention_layer_matches_reference(kind):
    """One layer of each kind against ``repro.models.attention.attention_block``:
    the encoder's non-causal self-attention and the decoder's causal one
    (neither with RoPE: whisper has learned positions), and the
    cross-attention over a memory of another length."""
    _, _, jparams, np_params, model = _reference()
    jcfg = JARCHS[NAME].reduced()
    stack, name = {"encoder": ("enc_blocks", "attn"), "decoder": ("dec_blocks", "attn"),
                   "cross": ("dec_blocks", "xattn")}[kind]
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams[stack][name])
    layer = getattr(getattr(model, stack)[1], name)
    rng = np.random.default_rng(len(kind))
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 14, 64)).astype(np.float32)
    pos = np.arange(9)
    kw = {"encoder": dict(causal=False), "decoder": {},
          "cross": dict(memory=jnp.asarray(mem))}[kind]
    want = jattention.attention_block(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), **kw)
    tkw = {"encoder": dict(causal=False), "decoder": {}, "cross": dict(memory=_t(mem))}[kind]
    with torch.no_grad():
        got = layer(_t(x), torch.from_numpy(pos), **tkw)
    _close(got, want, OP_TOL)


def test_rope_configs_still_rotate():
    """``use_rope`` decides: a RoPE config's q and k are rotated, whisper's not."""
    cfg = ARCHS["gemma2-9b"].reduced()
    layer = init_params(cfg, seed=0, device="cpu").layers[0].attn
    x = torch.randn(1, 5, cfg.d_model)
    q, k, _ = layer._qkv(x, torch.arange(5))
    q0, k0, _ = layer._qkv(x, torch.zeros(5, dtype=torch.long))
    assert not torch.allclose(q[:, 1:], q0[:, 1:]) and torch.equal(q[:, 0], q0[:, 0])
    _, _, _, _, model = _reference()
    w = model.dec_blocks[0].attn
    x = torch.randn(1, 5, 64)
    assert torch.equal(w._qkv(x, torch.arange(5))[0], w._qkv(x, torch.zeros(5).long())[0])


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_from_jax_params_round_trip():
    """Pytree -> modules -> re-stacked pytree gives back every leaf exactly."""
    jcfg, _, _, np_params, model = _reference()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    n = {"enc_blocks": jcfg.n_encoder_layers, "dec_blocks": jcfg.n_layers}

    def back(name, tree, path):
        if isinstance(tree, dict):
            return {k: back(name, v, f"{path}.{k}") for k, v in tree.items()}
        if name in n:
            return np.stack([sd[f"{name}.{i}{path}"] for i in range(n[name])])
        return sd[f"{name}{path}"]

    rebuilt = {name: back(name, tree, "") for name, tree in np_params.items()}
    jax.tree_util.tree_map(np.testing.assert_array_equal, rebuilt, np_params)
    n_leaves = sum(n.get(k, 1) * len(jax.tree_util.tree_leaves(v))
                   for k, v in np_params.items())
    assert len(sd) == n_leaves == 3 + 2 * 13 + 2 + 2 * 22 + 2
    with pytest.raises(ValueError, match="stacked"):
        short = dict(np_params, dec_blocks=jax.tree_util.tree_map(
            lambda a: a[:1], np_params["dec_blocks"]))
        jax_params_to_state_dict(ARCHS[NAME].reduced(), short)


def test_full_width_shapes_on_meta_device():
    """whisper-medium at full width without allocating: each port parameter
    has the shape of the reference leaf it loads from (a stacked leaf without
    its layer dim), and the totals agree."""
    cfg, jcfg = ARCHS[NAME], JARCHS[NAME]
    model = EncDec(cfg, torch.device("meta"), torch.bfloat16)
    shapes = jax.eval_shape(lambda k: jencdec.init_encdec_params(jcfg, k, jnp.bfloat16),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [str(e.key) for e in path]
        if keys[0] in ("enc_blocks", "dec_blocks"):
            for i in range(leaf.shape[0]):
                want[".".join([keys[0], str(i)] + keys[1:])] = tuple(leaf.shape[1:])
        else:
            want[".".join(keys)] = tuple(leaf.shape)
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == want
    assert (len(model.enc_blocks), len(model.dec_blocks)) == (24, 24)
    assert got["enc_pos"] == (1500, 1024) and got["dec_pos"] == (448, 1024)
    assert got["dec_blocks.23.xattn.wk"] == (1024, 16, 64)
    n = sum(int(np.prod(s)) for s in got.values())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert 7.6e8 < n < 7.7e8  # whisper-medium's 769M


def test_init_params_statistics():
    """Seeded init on the CPU: reference statistics, reproducible bits."""
    cfg = ARCHS[NAME].reduced()
    model = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    assert isinstance(model, EncDec)
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k
    for table in (model.embed, model.enc_pos, model.dec_pos):
        assert abs(float(table.std()) - 0.02) < 0.004
    w = model.dec_blocks[1].mlp.w_up
    assert float(w.abs().max()) <= 2.0 / np.sqrt(64) + 1e-6
    ln = model.dec_blocks[0].norm_x
    assert bool((ln["g"] == 1).all()) and not ln["b"].any()
    assert not model.dec_blocks[0].xattn.bk.any()


# ---------------------------------------------------------------------------
# The model API: encode, decode_train, decode steps
# ---------------------------------------------------------------------------

def test_encode_tiles_positions_and_matches_reference():
    jcfg, _, jparams, _, model = _reference()
    frames = _inputs(jcfg)["frames"]
    assert frames.shape[1] == 20 and model.enc_pos.shape[0] == 16
    want = jencdec.encode(jparams, jcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = model.encode(_t(frames))
    _close(got, want, LOGIT_TOL)


def test_decode_train_logits_match_reference():
    jcfg, _, jparams, _, model = _reference()
    batch = _inputs(jcfg)
    memory = jencdec.encode(jparams, jcfg, jnp.asarray(batch["frames"]))
    want = jencdec.decode_train(jparams, jcfg, jnp.asarray(batch["tokens"]), memory)
    with torch.no_grad():
        got = model.decode_train(torch.from_numpy(batch["tokens"]), _t(memory))
    assert got.shape == (2, 12, jcfg.vocab_size)
    _close(got, want, LOGIT_TOL)


def test_prefill_and_twelve_decode_steps_match_teacher_forcing_and_reference():
    """``Model.prefill`` is the encode; 12 decode steps from the empty cache
    against the teacher-forced logits and against the reference's steps."""
    jcfg, jmodel, jparams, _, model = _reference()
    batch = _inputs(jcfg, S=12)
    toks = batch["tokens"]
    api = build_model(ARCHS[NAME].reduced(), device="cpu")
    cache = api.init_cache(2, 32, torch.float32)
    assert len(cache["self"]) == jcfg.n_layers and cache["pos"] == 0
    assert tuple(cache["self"][0]["k"].shape) == (2, 32, 2, 16)
    jcache = jmodel.init_cache(2, 32, jnp.float32)
    jmemory, jcache = jmodel.prefill(jparams, {"frames": jnp.asarray(batch["frames"])}, jcache)
    jstep = jax.jit(jmodel.decode_step)
    with torch.inference_mode():
        memory, cache = api.prefill(model, {"frames": _t(batch["frames"])}, cache)
        _close(memory, jmemory, LOGIT_TOL)
        teacher = model.decode_train(torch.from_numpy(toks), memory)
        for t in range(12):
            tok = toks[:, t:t + 1]
            logits, cache = api.decode_step(model, cache, torch.from_numpy(tok), memory)
            jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok), memory=jmemory)
            _close(logits[:, 0], teacher[:, t], LOGIT_TOL)
            _close(logits, jlogits, LOGIT_TOL)
            np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                          np.asarray(jnp.argmax(jlogits, -1)))
    assert cache["pos"] == 12 == int(jcache["pos"])


def test_frames_in_another_dtype_than_the_weights_raise():
    model = init_params(ARCHS[NAME].reduced(), seed=0, device="cpu", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        model.encode(torch.zeros(1, 4, 64))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _reference_loss_and_grads(jmodel, np_params, batch, remat_policy):
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, remat_policy=remat_policy), has_aux=True)(jparams)
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), grads)
    return float(loss), jax_params_to_state_dict(ARCHS[NAME].reduced(), grads), metrics


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_encdec_loss_and_every_gradient_match_reference(policy):
    """The loss, ``moe_aux`` 0 and every leaf's gradient (each LayerNorm's,
    the positions', the tied embedding's) under ``policy`` on both sides,
    with a mask on the labels."""
    jcfg, jmodel, _, np_params, _ = _reference()
    batch = _inputs(jcfg, seed=4)
    batch["mask"] = (np.random.default_rng(5).random((2, 12)) < 0.7).astype(np.float32)
    model = from_jax_params(ARCHS[NAME].reduced(), np_params, device="cpu")
    model.requires_grad_(True)
    api = build_model(ARCHS[NAME].reduced(), device="cpu")
    loss, metrics = api.loss(model, _torch(batch), remat_policy=policy)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    loss = float(loss.detach())
    want_loss, want_grads, want_metrics = _reference_loss_and_grads(
        jmodel, np_params, batch, policy)
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["moe_aux"]) == float(want_metrics["moe_aux"]) == 0.0
    assert bool((grads["enc_pos"].abs().amax(-1) > 0).all())  # 20 frames reach all 16 rows
    _assert_grads_close_key_bias_apart(grads, want_grads, GRAD_TOL)


def test_remat_policies_give_the_gradients_of_none():
    cfg = ARCHS[NAME].reduced()
    batch = _torch(_inputs(cfg, seed=6))
    out = {}
    for policy in (None, "nothing", "dots", "dots_with_no_batch_dims"):
        model = init_params(cfg, seed=1, device="cpu").requires_grad_(True)
        loss, _ = build_model(cfg, device="cpu").loss(model, batch, remat_policy=policy)
        names, params = zip(*model.named_parameters())
        out[policy] = (loss, torch.autograd.grad(loss, params))
    base_loss, base = out.pop(None)
    for policy, (loss, grads) in out.items():
        assert torch.equal(loss, base_loss), policy
        for g, b in zip(grads, base):
            torch.testing.assert_close(g, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_loop_tracks_reference_losses(grad_accum):
    """Four AdamW steps of ``train_loop`` from the same converted init on the
    same frame/token batch, repeated so that the loss must fall (fp32
    compute, remat "nothing")."""
    jcfg, jmodel, _, np_params, _ = _reference()
    batches = [_inputs(jcfg, B=4, T=16, S=10, seed=10)] * 4
    opt = dict(lr=1e-2, weight_decay=0.1)
    jrun = JTrainRunConfig(optimizer=joptim.AdamWConfig(**opt), total_steps=4,
                           warmup_steps=1, compute_dtype=jnp.float32, grad_accum=grad_accum)
    run = TrainRunConfig(optimizer=optimizer.AdamWConfig(**opt), total_steps=4,
                         warmup_steps=1, compute_dtype=torch.float32, grad_accum=grad_accum)
    _, _, jhist = jtrain_loop(jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
                              ({k: jnp.asarray(v) for k, v in b.items()} for b in batches),
                              jrun, log_every=1)
    model = from_jax_params(ARCHS[NAME].reduced(), np_params, device="cpu")
    model, state, hist = train_loop(build_model(ARCHS[NAME].reduced(), device="cpu"), model,
                                    batches, run, log_every=1)
    assert state.step == 4 and [h["step"] for h in hist] == [1, 2, 3, 4]
    for h, jh in zip(hist, jhist):
        assert abs(h["loss"] - jh["loss"]) <= 1e-4 * abs(jh["loss"]), (h, jh)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_sharded_init_cache_lays_out_the_self_caches():
    """``ShardedModel`` serves the encoder-decoder
    (``tests/test_torch_whisper_tp_serve.py``), and its ``init_cache`` lays
    out the decoder's ``"self"`` caches, one a
    block, each K/V leaf a DTensor as an LM's: rows over ``data`` under
    ``fsdp_tp`` and the 64 slots over ``model`` (over ``data`` and ``model``
    under ``serve_2d``), on a fake (data 2, model 2) world, shapes on meta."""
    cfg = ARCHS[NAME].reduced()
    layouts = {"fsdp_tp": ((Shard(0), Shard(1)), (2, 32, 2, 16)),
               "serve_2d": ((Shard(1), Shard(1)), (4, 16, 2, 16))}
    for strategy, want in layouts.items():
        with _mesh((2, 2)) as mesh:
            model = ShardedModel(build_model(cfg, device="meta"), mesh, STRATEGIES[strategy]())
            cache = model.init_cache(4, 64)
        assert sorted(cache) == ["pos", "self"] and cache["pos"] == 0
        assert len(cache["self"]) == cfg.n_layers
        for c in cache["self"]:
            assert sorted(c) == ["k", "v"]
            for t in c.values():
                assert isinstance(t, DTensor) and t.shape == (4, 64, 2, 16)
                assert (t.placements, tuple(t.to_local().shape)) == want, strategy


def test_bf16_compute_over_fp32_masters_tracks_the_reference():
    """``compute_dtype`` bf16 with bf16 frames, as the reference's input
    specs give them: the loss within 1e-3 and each gradient within 5e-2 of
    its leaf's largest (``test_torch_train.py``'s bf16 tolerances: the two
    frameworks round activations to bf16 at different places)."""
    jcfg, jmodel, _, np_params, _ = _reference()
    batch = _inputs(jcfg, seed=7)
    frames16 = jnp.asarray(batch["frames"], jnp.bfloat16)
    jbatch = {"frames": frames16, "tokens": jnp.asarray(batch["tokens"]),
              "labels": jnp.asarray(batch["labels"])}
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    (want_loss, _), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, compute_dtype=jnp.bfloat16), has_aux=True)(jparams)
    want_grads = jax_params_to_state_dict(
        ARCHS[NAME].reduced(), jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32),
                                                      jgrads))
    model = from_jax_params(ARCHS[NAME].reduced(), np_params, device="cpu").requires_grad_(True)
    tb = _torch(batch)
    tb["frames"] = _t(frames16.astype(jnp.float32)).bfloat16()
    loss, _ = build_model(ARCHS[NAME].reduced(), device="cpu").loss(
        model, tb, compute_dtype=torch.bfloat16)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert abs(float(loss) - float(want_loss)) <= 1e-3 * abs(float(want_loss))
    _assert_grads_close_key_bias_apart(grads, want_grads, 5e-2)
