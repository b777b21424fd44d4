"""The vision prefix (internvl2-76b) on the port vs the JAX reference, on the
CPU at the reduced config.

internvl2's frontend is a stub that hands the backbone ``prefix_embeds``
[B, P, d] (one image tile of P rows); the backbone puts them before the
token embeddings. The same numpy weights (the reference's pytree, carried
across by ``from_jax_params``) and numpy inputs go through both sides.

Tolerances, fp32 unless stated (those of ``test_torch_models.py`` and
``test_torch_train.py``): logits 2e-4 after a whole model; the loss 1e-5 and
every gradient 2e-5 of its leaf's largest; bf16 compute over fp32 masters
1e-3 on the loss and 5e-2 of each leaf's largest gradient (the frameworks
round activations to bf16 at different places). The sharded runs on 4 gloo
ranks against one process: 1e-5 (only the rows each rank multiplies
differ).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_models as torch_models
from repro.models import transformer as jtransformer
from repro_torch.configs import ARCHS
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import lm_loss

from _torch_ranks import run_ranks
from test_torch_models import LOGIT_TOL, _close, _reference
from test_torch_train import (BF16_GRAD_TOL, BF16_LOSS_TOL, GRAD_TOL, LOSS_TOL,
                              _assert_grads_close, _port_loss_and_grads,
                              _reference_loss_and_grads, _two_threads)  # noqa: F401

NAME = "internvl2-76b"
SHARD_TOL = 1e-5


def _inputs(cfg, B=2, S=24, seed=5):
    """Tokens, labels and a prefix of ``cfg.frontend_seq_len`` rows."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "prefix_embeds": rng.standard_normal(
                (B, cfg.frontend_seq_len, cfg.d_model)).astype(np.float32)}


def _torch_batch(batch, keys=None):
    return {k: torch.from_numpy(v) for k, v in batch.items() if keys is None or k in keys}


def test_reduced_config_has_a_vision_prefix():
    cfg = ARCHS[NAME].reduced()
    assert cfg.frontend == "vision" and cfg.frontend_seq_len == 16
    assert not cfg.is_encoder_decoder and cfg.mixer_pattern == ("attn",)


def test_prefill_logits_with_a_prefix_match_reference():
    jcfg, jmodel, jparams, _, lm = _reference(NAME)
    batch = _inputs(jcfg)
    B, S = batch["tokens"].shape
    P = jcfg.frontend_seq_len
    jcache = jmodel.init_cache(B, max_len=64, dtype=jnp.float32)
    jlogits, jcache = jmodel.prefill(
        jparams, {k: jnp.asarray(batch[k]) for k in ("tokens", "prefix_embeds")}, jcache)
    model = build_model(ARCHS[NAME].reduced(), device="cpu")
    cache = model.init_cache(B, 64, torch.float32)
    with torch.inference_mode():
        logits, cache = model.prefill(lm, _torch_batch(batch, ("tokens", "prefix_embeds")),
                                      cache)
    assert logits.shape == (B, 1, jcfg.vocab_size)
    _close(logits, jlogits, LOGIT_TOL)
    assert cache["pos"] == P + S == int(jcache["pos"])
    # the cache holds the prefix's keys too: the reference's, position by position
    _close(cache["layers"][0]["k"][:, :P + S], jcache["blocks"][0]["k"][0, :, :P + S],
           LOGIT_TOL)


def test_greedy_decode_after_the_prefix_matches_reference_and_teacher_forcing():
    """Prefill a prefix and 24 tokens, then 12 greedy steps: each step's
    logits track the reference's decode step fed the same token and the
    teacher-forced forward over prefix + prompt + the greedy tokens."""
    jcfg, jmodel, jparams, _, lm = _reference(NAME)
    batch = _inputs(jcfg)
    B, S = batch["tokens"].shape
    P, steps = jcfg.frontend_seq_len, 12
    model = build_model(ARCHS[NAME].reduced(), device="cpu")
    jcache = jmodel.init_cache(B, max_len=64, dtype=jnp.float32)
    jlogits, jcache = jmodel.prefill(
        jparams, {k: jnp.asarray(batch[k]) for k in ("tokens", "prefix_embeds")}, jcache)
    jdecode = jax.jit(jmodel.decode_step)
    cache = model.init_cache(B, 64, torch.float32)
    got, tokens = [], []
    with torch.inference_mode():
        logits, cache = model.prefill(lm, _torch_batch(batch, ("tokens", "prefix_embeds")),
                                      cache)
        for _ in range(steps):
            tok = logits.argmax(-1)
            assert torch.equal(tok, torch.from_numpy(np.array(jlogits.argmax(-1))))
            tokens.append(tok)
            jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok.numpy()))
            logits, cache = model.decode_step(lm, cache, tok)
            _close(logits, jlogits, LOGIT_TOL)
            got.append(logits)
        assert cache["pos"] == P + S + steps
        full = torch.cat([torch.from_numpy(batch["tokens"]).long()] + tokens, dim=1)
        forced, _ = lm(full, prefix_embeds=torch.from_numpy(batch["prefix_embeds"]))
    want, _ = jtransformer.lm_forward(jparams, jcfg, jnp.asarray(full.numpy()),
                                      jnp.asarray(batch["prefix_embeds"]))
    assert forced.shape == (B, P + S + steps, jcfg.vocab_size)
    _close(forced, want, LOGIT_TOL)
    for i, logits in enumerate(got):  # step i's input sits at position P + S + i
        _close(logits[:, 0], forced[:, P + S + i], LOGIT_TOL)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_lm_loss_and_every_gradient_with_a_prefix_match_reference(policy):
    """The loss is over the token positions only: the prefix's logits are cut."""
    cfg = ARCHS[NAME].reduced()
    _, jmodel, _, np_params, _ = _reference(NAME)
    batch = _inputs(cfg)
    loss, metrics, grads = _port_loss_and_grads(cfg, np_params, batch, remat_policy=policy)
    want_loss, want_grads, _ = _reference_loss_and_grads(cfg, jmodel, np_params, batch,
                                                         remat_policy=policy)
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    assert float(metrics["xent"].detach()) == float(loss)
    _assert_grads_close(grads, want_grads, GRAD_TOL)
    # the prefix changes the loss: it is not dropped
    no_prefix, _, _ = _port_loss_and_grads(
        cfg, np_params, {k: v for k, v in batch.items() if k != "prefix_embeds"})
    assert abs(float(no_prefix) - float(loss)) > 1e-4


def test_bf16_compute_over_fp32_masters_with_a_prefix_matches_reference():
    cfg = ARCHS[NAME].reduced()
    _, jmodel, _, np_params, _ = _reference(NAME)
    batch = _inputs(cfg)
    loss, _, grads = _port_loss_and_grads(cfg, np_params, batch, compute_dtype=torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in grads.values())
    want_loss, want_grads, _ = _reference_loss_and_grads(cfg, jmodel, np_params, batch,
                                                         compute_dtype=jnp.bfloat16)
    assert abs(float(loss) - want_loss) <= BF16_LOSS_TOL * abs(want_loss)
    _assert_grads_close(grads, want_grads, BF16_GRAD_TOL)


def test_from_jax_params_round_trip():
    torch_models.test_from_jax_params_round_trip(NAME)


def test_full_width_shapes_on_meta_device():
    torch_models.test_full_width_shapes_on_meta_device(NAME)


# ---------------------------------------------------------------------------
# Sharded: 4 gloo ranks on a (2, 2) mesh against one process
# ---------------------------------------------------------------------------

_SHARDED = """
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel
from repro_torch.weights import from_jax_params

cfg, np_params, batch, steps = inputs
mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"), "cpu")
model = ShardedModel(build_model(cfg, device="cpu"), mesh, shd.STRATEGIES["fsdp_tp"]())
lm = model.shard(from_jax_params(cfg, np_params, device="cpu"))
tb = {k: torch.from_numpy(v) for k, v in batch.items()}
lm.requires_grad_(True)
loss, _ = model.loss(lm, tb, remat_policy="nothing")
names, params = zip(*lm.named_parameters())
grads = torch.autograd.grad(loss, params)
result = {"loss": float(loss),
          "grads": {n: g.full_tensor().numpy() for n, g in zip(names, grads)}}
lm.requires_grad_(False)
B = batch["tokens"].shape[0]
cache = model.init_cache(B, 64, torch.float32)
result["cache_local"] = tuple(cache["layers"][0]["k"].to_local().shape)
with torch.no_grad():
    logits, cache = model.prefill(lm, {k: tb[k] for k in ("tokens", "prefix_embeds")}, cache)
    out = [logits.full_tensor().numpy()]
    for t in range(steps):
        logits, cache = model.decode_step(lm, cache, torch.from_numpy(batch["labels"][:, t:t + 1]))
        out.append(logits.full_tensor().numpy())
result["logits"] = out
result["pos"] = cache["pos"]
"""


def test_sharded_loss_prefill_and_decode_with_a_prefix_equal_one_process(tmp_path):
    cfg = ARCHS[NAME].reduced()
    _, _, _, np_params, lm = _reference(NAME)
    batch = _inputs(cfg, B=4, S=20)
    steps = 3
    ranks = run_ranks(_SHARDED, 4, tmp_path, inputs=(cfg, np_params, batch, steps))
    loss, _, grads = _port_loss_and_grads(cfg, np_params, batch, remat_policy="nothing")
    model = build_model(cfg, device="cpu")
    cache = model.init_cache(4, 64, torch.float32)
    with torch.no_grad():
        logits, cache = model.prefill(lm, _torch_batch(batch, ("tokens", "prefix_embeds")),
                                      cache)
        want = [logits]
        for t in range(steps):
            logits, cache = model.decode_step(
                lm, cache, torch.from_numpy(batch["labels"][:, t:t + 1]))
            want.append(logits)
    for res in ranks:
        assert abs(res["loss"] - float(loss)) <= SHARD_TOL * abs(float(loss))
        assert sorted(res["grads"]) == sorted(grads)
        for n, g in grads.items():
            np.testing.assert_allclose(res["grads"][n], g.numpy(), atol=SHARD_TOL,
                                       rtol=SHARD_TOL)
        # at rest each rank holds its 2 rows and half of the 64 cache slots
        assert res["cache_local"] == (2, 32, cfg.n_kv_heads, cfg.head_dim)
        assert len(res["logits"]) == steps + 1 and res["pos"] == cache["pos"]
        for got, w in zip(res["logits"], want):
            np.testing.assert_allclose(got, w.numpy(), atol=SHARD_TOL, rtol=SHARD_TOL)


def test_lm_loss_takes_the_prefix_through_compute_dtype_casts():
    """Under compute_dtype the prefix is cast to the compute dtype at the
    concatenation, whatever dtype it came in."""
    cfg = dataclasses.replace(ARCHS[NAME].reduced(), n_layers=1)
    lm = build_model(cfg, device="cpu").init(0)
    b = {k: torch.from_numpy(v) for k, v in _inputs(cfg, B=1, S=6).items()}
    bf16 = {**b, "prefix_embeds": b["prefix_embeds"].bfloat16()}
    with torch.no_grad():
        a, _ = lm_loss(lm, b, compute_dtype=torch.bfloat16)
        c, _ = lm_loss(lm, bf16, compute_dtype=torch.bfloat16)
    assert a.dtype == torch.float32 and torch.isfinite(a)
    assert float(a) == float(c)
