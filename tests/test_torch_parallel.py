"""The port's ``parallel/`` and ``launch/mesh.py`` against the JAX reference,
on the CPU.

Specs are compared exactly: the rule tables, the resolver, the leaf and
cache tables, and every parameter's, cache leaf's and batch's spec, for all
five strategies on (2, 2), (4, 2) and (2, 16, 16) meshes, for reduced and
full-width gemma-7b, recurrentgemma-9b and rwkv6-7b (full width from
``jax.eval_shape`` and the ``meta`` device: nothing full-width is
allocated). The reference stacks a pattern position's layers on a leading
``"layers"`` dim; its spec there is ``None`` and is dropped before the
comparison.

Multi-rank cases run on gloo ranks, each its own process
(``tests/_torch_ranks.py``: a ``file://`` store, one thread, a time limit).
Tolerances:
  * int8 quantization: bit for bit (both round half to even);
  * the compressed psum: the reference's own bound, absmax/127 per element
    per participant;
  * the pipeline against the JAX oracle: 1e-5 (fp32, tanh stages);
  * sharded training on a 2 x 2 mesh against the single-process loop, fp32,
    6 steps: losses 1e-5 relative, parameters 1e-5 absolute, but for the
    few where AdamW amplifies the split's rounding (below). With
    ``REPRO_GRAD_SYNC_BF16=1`` on both sides the losses hold 1e-5; a
    parameter may move by one bf16 rounding of its gradient a step, where
    the fp32 sums of the two sides land on either side of a bf16 rounding
    boundary: lr * 2^-8 a step (about 2e-5 is seen against
    6 * 3e-3 * 2^-8 = 7.0e-5). In float64 (masters, compute and moments) on
    both sides, losses 1e-5 relative and every parameter 1e-5 absolute
    (1.4e-6 is seen). With ``REPRO_CAST_BARRIER=1`` in bf16 compute, against
    the knob-off run on the same ranks: bit for bit, losses and parameters.
    The bf16 cast of a gathered fp32 block is the gather of its bf16 cast,
    and each gradient is widened to fp32 before its reduction, as the
    knob-off run's cast widens it, so the two runs add the same fp32 terms in
    the same collectives (a bf16 reduction instead was measured to part
    the parameters by up to 8.1e-3 after 6 steps: bf16 compute turns a
    rounding of the gradient into other bf16 weights).

The model axis splits the compute (attention by heads, the MLP by
``d_ff``, the head by vocabulary), so the split's fp32 sums run in another
order than the single process's: a gradient parts by about 3e-6 of its
leaf's largest (2.6e-6 is seen, 5.1e-7 where every rank computed the same
rows whole). AdamW's step, g / (|g| + 1e-8) at first, turns that into up to
a whole step at an element whose gradient lies within a few eps of 0: in
fp32, 11 of reduced recurrentgemma-9b's 340032 parameters end beyond 1e-5,
the largest by 5.3e-5 (``layers.1.mlp.w_down[15, 49]``, whose first
gradient is -2.588e-8 in one process and -3.050e-8 sharded); in
``tests/test_torch_tp_train.py`` one of reduced qwen3-moe's 484736 by
9.3e-4, 0.31 of a step at the peak lr. So in fp32 a parameter is held to
FP32_SPLIT_PARAM_ATOL, one step at the peak lr, and all but a share
SPLIT_OUTLIERS of a model's parameters (3.2e-5 is seen) to 1e-5; the
float64 mode holds every one to 1e-5.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import repro.core as jcore
from repro.configs import ARCHS as JARCHS
from repro.launch import mesh as jmesh
from repro.models import transformer as jtransformer
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import collectives as jcoll
from repro.parallel import pipeline as jpipe
from repro.parallel import sharding as jshd
import repro_torch.core as core
from repro_torch.configs import ARCHS
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import mesh as pmesh
from repro_torch.models import transformer
from repro_torch.models.encdec import EncDec
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import LM
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import pipeline as pipe
from repro_torch.parallel import sharding as shd
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainRunConfig, train_loop

from _torch_ranks import run_ranks

MESHES = {(2, 2): ("data", "model"), (4, 2): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
ARCH_NAMES = ["gemma-7b", "recurrentgemma-9b", "rwkv6-7b"]
PIPE_TOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
TRAIN_STEPS, TRAIN_LR = 6, 3e-3
BF16_PARAM_ATOL = TRAIN_STEPS * TRAIN_LR * 2.0 ** -8
FP32_SPLIT_PARAM_ATOL = TRAIN_LR
SPLIT_OUTLIERS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Six test workers share eight cores: cap torch's pool, then restore it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _meshes(shape):
    axes = MESHES[shape]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _cfgs(name, full):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    return (cfg, jcfg) if full else (cfg.reduced(), jcfg.reduced())


def _spec(p):
    return tuple(p)


def _leaves(tree, leaf_type=None):
    """(keys, leaf) of a pytree, keys as plain dict keys and list indices."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=None if leaf_type is None else lambda x: isinstance(x, leaf_type))[0]
    return [([getattr(k, "key", getattr(k, "idx", None)) for k in path], leaf)
            for path, leaf in flat]


def _port_names(cfg, keys):
    """The port's names of a reference leaf, and whether it is stacked
    (``blocks``: one entry a group, the leading dim dropped)."""
    n_groups, _ = cfg.n_groups_and_tail()
    p = len(cfg.mixer_pattern)
    rest = ".".join(str(k) for k in keys[2:])
    if keys[0] == "blocks":
        return [f"layers.{g * p + keys[1]}.{rest}" for g in range(n_groups)], True
    if keys[0] == "tail":
        return [f"layers.{n_groups * p + keys[1]}.{rest}"], False
    return [".".join(str(k) for k in keys)], False


def _nested(flat):
    """Dotted names -> nested dicts (so the reference's leaf name, the last
    dict key, is the port's)."""
    tree = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _in_port_layout(cfg, jtree):
    """The reference's parameter shapes laid out as the port's state dict:
    a stacked leaf becomes one leaf a layer without the leading dim."""
    flat = {}
    for keys, leaf in _leaves(jtree):
        names, stacked = _port_names(cfg, keys)
        for name in names:
            flat[name] = jax.ShapeDtypeStruct(leaf.shape[1:] if stacked else leaf.shape,
                                              leaf.dtype)
    return flat


def _by_port_name(cfg, tree, leaf_type):
    """A reference spec pytree in the reference's layout keyed by the
    port's names: a stacked leaf's spec loses its leading entry (the
    ``"layers"`` dim) and repeats for each group. Also returns the names
    whose leading entry was not None."""
    out, sharded_lead = {}, set()
    for keys, leaf in _leaves(tree, leaf_type):
        spec = _spec(leaf.spec if hasattr(leaf, "spec") else leaf)
        names, stacked = _port_names(cfg, keys)
        if stacked and spec[0] is not None:
            sharded_lead.update(names)
        for name in names:
            out[name] = spec[1:] if stacked else spec
    return out, sharded_lead


# ---------------------------------------------------------------------------
# Rule tables and specs
# ---------------------------------------------------------------------------

def test_rule_tables_and_leaf_tables_are_the_reference():
    assert list(shd.STRATEGIES) == list(jshd.STRATEGIES)
    for name in jshd.STRATEGIES:
        assert shd.STRATEGIES[name]() == jshd.STRATEGIES[name](), name
    assert shd.PARAM_LOGICAL == jshd.PARAM_LOGICAL
    assert shd._MOE_LEAVES == jshd._MOE_LEAVES
    assert shd.CACHE_LOGICAL == jshd.CACHE_LOGICAL
    for name in list(jshd.PARAM_LOGICAL) + ["scale", "bias", "unknown"]:
        for ndim in range(6):
            assert shd.logical_for_leaf(name, ndim) == jshd.logical_for_leaf(name, ndim)


@pytest.mark.parametrize("shape", list(MESHES))
def test_resolve_spec_matches_reference(shape):
    amesh, sizes = _meshes(shape)
    rng = random.Random(sum(shape))
    names = sorted({k for s in jshd.STRATEGIES.values() for k in s()}) + [None, "absent"]
    dims = [1, 2, 3, 4, 6, 8, 16, 32, 48, 64, 256, 4096]
    for strategy in jshd.STRATEGIES:
        rules = jshd.STRATEGIES[strategy]()
        for _ in range(300):
            n = rng.randint(0, 4)
            logical = [rng.choice(names) for _ in range(n)]
            dim_sizes = [rng.choice(dims) for _ in range(n)]
            want = jshd.resolve_spec(amesh, rules, logical, dim_sizes)
            assert shd.resolve_spec(sizes, rules, logical, dim_sizes) == _spec(want), \
                (strategy, logical, dim_sizes)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("shape", list(MESHES))
def test_param_specs_match_reference(shape, name, full):
    """``param_specs`` of the port's module equals the reference's on the
    same shapes in the port's layout (one leaf a layer); the reference's
    stacked specs without their leading entry equal it too, but for the
    dense MLP weights, whose stacked shape has the rank of an MoE expert
    weight: ``logical_for_leaf`` gives them the ``experts`` axes there
    (``repro/parallel/sharding.py:282-289``), so their layer dim may take
    the ``model`` axis. The port has no stacked dim and keeps the dense rule."""
    amesh, sizes = _meshes(shape)
    cfg, jcfg = _cfgs(name, full)
    jshapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    lm = LM(cfg, torch.device("meta"), torch.float32)
    layout = _in_port_layout(cfg, jshapes)
    assert {n: tuple(p.shape) for n, p in lm.named_parameters()} == {
        n: tuple(s.shape) for n, s in layout.items()}
    mlp = {"w_gate", "w_up", "w_down"}
    for strategy in jshd.STRATEGIES:
        rules = jshd.STRATEGIES[strategy]()
        want = {".".join(str(k) for k in keys): _spec(spec) for keys, spec in
                _leaves(jshd.param_specs(amesh, rules, _nested(layout)), P)}
        got = shd.param_specs(sizes, rules, lm)
        assert got == want, strategy
        assert {n: s.spec for n, s in shd.param_shardings(sizes, rules, lm).items()} == want
        stacked, sharded_lead = _by_port_name(
            cfg, jshd.param_specs(amesh, rules, jshapes), P)
        assert {n.rsplit(".", 1)[-1] for n in sharded_lead} <= mlp, strategy
        assert {n: v for n, v in stacked.items() if n not in sharded_lead} == {
            n: v for n, v in got.items() if n not in sharded_lead}, strategy


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("shape", list(MESHES))
def test_cache_and_batch_specs_match_reference(shape, name, full):
    amesh, sizes = _meshes(shape)
    cfg, jcfg = _cfgs(name, full)
    batch, max_len = (16, 4096) if full else (4, 64)
    jcache = jax.eval_shape(lambda: jtransformer.init_decode_cache(
        jcfg, batch, max_len, jnp.float32))
    cache = transformer.init_decode_cache(cfg, batch, max_len, torch.float32,
                                          torch.device("meta"))
    jbatch = {"tokens": jax.ShapeDtypeStruct((batch, max_len), jnp.int32),
              "labels": jax.ShapeDtypeStruct((batch, max_len), jnp.int32),
              "embeds": jax.ShapeDtypeStruct((batch, max_len, 8), jnp.float32)}
    for strategy in jshd.STRATEGIES:
        rules = jshd.STRATEGIES[strategy]()
        want, sharded_lead = _by_port_name(
            cfg, jshd.cache_shardings(amesh, rules, jcache), jax.sharding.NamedSharding)
        assert not sharded_lead
        got = shd.cache_shardings(sizes, rules, cache)
        flat = {f"layers.{i}.{k}": s.spec for i, layer in enumerate(got["layers"])
                for k, s in layer.items()}
        flat["pos"] = got["pos"].spec
        assert flat == want, strategy
        jb = jshd.batch_specs(amesh, rules, jbatch)
        assert shd.batch_specs(sizes, rules, jbatch) == {k: _spec(v) for k, v in jb.items()}


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("shape", list(MESHES))
def test_whisper_param_and_batch_specs_match_reference(shape, full):
    """whisper-medium, every strategy: ``param_specs`` of the port's EncDec
    equals the reference's on the same shapes in the port's layout (one leaf
    a layer of ``enc_blocks`` / ``dec_blocks``), and the reference's stacked
    specs without their leading entry but for the dense MLP weights (see
    ``test_param_specs_match_reference``). ``enc_pos`` and ``dec_pos`` have
    no ``PARAM_LOGICAL`` entry and replicate on both sides; the LayerNorms
    too. The frames / tokens batch resolves as the reference's."""
    amesh, sizes = _meshes(shape)
    cfg, jcfg = _cfgs("whisper-medium", full)
    jshapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    model = EncDec(cfg, torch.device("meta"), torch.float32)
    layout, stacked_of = {}, {}
    for keys, leaf in _leaves(jshapes):
        if keys[0] in ("enc_blocks", "dec_blocks"):
            for i in range(leaf.shape[0]):
                name = ".".join([keys[0], str(i)] + [str(k) for k in keys[1:]])
                layout[name] = jax.ShapeDtypeStruct(leaf.shape[1:], leaf.dtype)
                stacked_of[name] = ".".join(str(k) for k in keys)
        else:
            layout[".".join(str(k) for k in keys)] = leaf
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(s.shape) for n, s in layout.items()}
    mlp = {"w_up", "w_down"}
    B, T, S = (16, 1500, 448) if full else (4, 16, 12)
    jbatch = {"frames": jax.ShapeDtypeStruct((B, T, cfg.d_model), jnp.bfloat16),
              "tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    for strategy in jshd.STRATEGIES:
        rules = jshd.STRATEGIES[strategy]()
        want = {".".join(str(k) for k in keys): _spec(spec) for keys, spec in
                _leaves(jshd.param_specs(amesh, rules, _nested(layout)), P)}
        got = shd.param_specs(sizes, rules, model)
        assert got == want, strategy
        assert got["enc_pos"] == got["dec_pos"] == (None, None)
        assert got["enc_blocks.0.norm1.g"] == got["dec_norm.b"] == (None,)
        stacked = {".".join(str(k) for k in keys): _spec(spec) for keys, spec in
                   _leaves(jshd.param_specs(amesh, rules, jshapes), P)}
        for name, spec in got.items():
            lead = stacked.get(stacked_of.get(name))
            if lead is None:
                assert stacked[name] == spec, (strategy, name)
            elif lead[0] is None:
                assert lead[1:] == spec, (strategy, name)
            else:
                assert name.rsplit(".", 1)[-1] in mlp, (strategy, name)
        jb = jshd.batch_specs(amesh, rules, jbatch)
        assert shd.batch_specs(sizes, rules, jbatch) == {k: _spec(v) for k, v in jb.items()}


def test_placements_split_a_dim_over_axes_in_mesh_order():
    sizes = {"pod": 2, "data": 4, "model": 2}
    assert shd.placements(sizes, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(sizes, (None, "data")) == (Replicate(), Shard(1), Replicate())
    assert shd.NamedSharding(sizes, ("model",)).placements == (
        Replicate(), Replicate(), Shard(0))
    with pytest.raises(ValueError, match="not in mesh order"):
        shd.placements(sizes, (("data", "pod"),))


def test_shard_activation_is_a_no_op_on_local_tensors():
    x = torch.ones(4, 8)
    assert shd.shard_activation(x, "batch", "act_embed") is x
    with shd.use_sharding({"data": 2, "model": 2}):
        assert shd.get_context() is not None
        assert shd.shard_activation(x, "batch", "act_embed") is x
    assert shd.get_context() is None


# ---------------------------------------------------------------------------
# Collectives, pipeline and layout on 4 gloo ranks
# ---------------------------------------------------------------------------

PIPE = dict(n_stages=4, n_micro=6, mb=2, d=16)


def _pipe_inputs():
    rng = np.random.default_rng(0)
    s, d = PIPE["n_stages"], PIPE["d"]
    params = {"w": (rng.standard_normal((s, d, d)) * 0.5).astype(np.float32),
              "b": (rng.standard_normal((s, d)) * 0.1).astype(np.float32)}
    x = rng.standard_normal((PIPE["n_micro"], PIPE["mb"], d)).astype(np.float32)
    return params, x


def _psum_inputs():
    """Each rank's tensor (the reference test's (4, 8, 256) draw) and a
    ragged gradient tree with a carried residual."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 256)).astype(np.float32)
    grads = [{"w": rng.standard_normal((5, 300)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)} for _ in range(4)]
    residual = [{k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in g.items()} for g in grads]
    return x, grads, residual


_FOUR_RANKS = """
import numpy as np
from torch.distributed.tensor import distribute_tensor
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.parallel import collectives as coll, pipeline as pipe, sharding as shd
result = {}
# layout: dim 0 over ("pod", "data")
mesh = make_mesh_from_devices(range(4), (2, 2), ("pod", "data"), "cpu")
whole = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
spec = (("pod", "data"), None)
dt = distribute_tensor(whole, mesh, shd.placements(mesh, spec), src_data_rank=None)
result["coord"] = mesh.get_coordinate()
result["block"] = dt.to_local().numpy()
result["whole"] = dt.full_tensor().numpy()
with shd.use_sharding(mesh, {"batch": "pod"}):
    act = shd.shard_activation(dt, "batch", None)
result["activation"] = (act.placements, act.to_local().numpy())
# compressed psum and grad sync over the world
x, grads, residual = inputs["psum"]
result["psum"] = coll.compressed_psum_int8(torch.from_numpy(x[rank])).numpy()
g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
r = {k: torch.from_numpy(v) for k, v in residual[rank].items()}
synced, new_res = coll.compressed_grad_sync(g, None, r)
result["synced"] = {k: v.numpy() for k, v in synced.items()}
result["residual"] = {k: v.numpy() for k, v in new_res.items()}
# the pipeline over a 4-stage "pod" axis
pmesh = make_mesh_from_devices(range(4), (4,), ("pod",), "cpu")
params, xs = inputs["pipe"]
stage = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
result["pipe"] = pipe.pipeline_apply(stage, {k: torch.from_numpy(v) for k, v in params.items()},
                                     torch.from_numpy(xs), pmesh, axis="pod").numpy()
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(_FOUR_RANKS, 4, tmp_path_factory.mktemp("four"),
                     inputs={"psum": _psum_inputs(), "pipe": _pipe_inputs()})


def test_dtensor_layout_is_jax_row_major_over_the_axes(four_ranks):
    """P(("pod", "data")) gives the device at mesh position (i, j) block
    i * |data| + j of the dim, JAX's row-major order; DTensor's placements
    from ``sharding.placements`` give the same blocks."""
    whole = np.arange(24, dtype=np.float32).reshape(8, 3)
    for res in four_ranks:
        i, j = res["coord"]
        k = i * 2 + j
        np.testing.assert_array_equal(res["block"], whole[2 * k:2 * k + 2])
        np.testing.assert_array_equal(res["whole"], whole)
        placements, block = res["activation"]  # redistributed to dim 0 over "pod" only
        assert tuple(placements) == (Shard(0), Replicate())
        np.testing.assert_array_equal(block, whole[4 * i:4 * i + 4])


def test_quantize_int8_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((16, 256)) * 10).astype(np.float32)
    x[0] = 0.0                                               # absmax 0: scale 1
    x[1] = np.arange(256, dtype=np.float32) / 2 - 63.5       # ties at scale 0.5
    x[1, 0] = 127.0                                          # absmax 127: scale 1, ties at .5
    x[2] = np.float32(1e-30) * rng.standard_normal(256)      # tiny scale
    q, s = coll.quantize_int8(torch.from_numpy(x))
    jq, js = jcoll.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(coll.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcoll.dequantize_int8(jq, js)))


def test_compressed_psum_equals_the_exact_sum_within_the_reference_bound(four_ranks):
    x, _, _ = _psum_inputs()
    tol = float(np.abs(x).max() / 127 * 4 + 1e-6)
    for res in four_ranks:
        np.testing.assert_allclose(res["psum"], x.sum(0), atol=tol)
    for res in four_ranks[1:]:
        np.testing.assert_array_equal(res["psum"], four_ranks[0]["psum"])


def test_compressed_grad_sync_residual_matches_reference(four_ranks):
    """Each rank's residual is the reference's on its gradients (a
    one-device shard_map: the residual is local) within 2 ulp of the
    gradient (XLA fuses g - q * scale into one rounding); the synced sum
    holds the psum bound."""
    _, grads, residual = _psum_inputs()
    jm = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    fn = jax.jit(jax.shard_map(
        lambda g, r: jcoll.compressed_grad_sync(g, "dp", r), mesh=jm,
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))
    for rank, res in enumerate(four_ranks):
        _, jres = fn(grads[rank], residual[rank])
        for k in grads[rank]:
            g = grads[rank][k] + residual[rank][k]
            ulp2 = 2 * np.spacing(np.abs(g).astype(np.float32))
            assert np.all(np.abs(res["residual"][k] - np.asarray(jres[k])) <= ulp2), k
    for k in grads[0]:
        total = sum(g[k] + r[k] for g, r in zip(grads, residual))
        bound = sum(float(np.abs(g[k] + r[k]).max()) for g, r in zip(grads, residual)) / 127
        for res in four_ranks:
            np.testing.assert_allclose(res["synced"][k], total, atol=bound + 1e-6)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1_000_000, 12_345_678])
@pytest.mark.parametrize("participants", [1, 2, 4, 16])
def test_wire_bytes_match_reference(n, participants):
    assert coll.wire_bytes_fp32_allreduce(n, participants) == \
        jcoll.wire_bytes_fp32_allreduce(n, participants)
    assert coll.wire_bytes_int8_allgather(n, participants) == \
        jcoll.wire_bytes_int8_allgather(n, participants)


def test_pipeline_apply_on_four_stages_matches_the_jax_oracle(four_ranks):
    params, x = _pipe_inputs()
    want = np.asarray(jpipe.pipeline_reference(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x)))
    for res in four_ranks:
        np.testing.assert_allclose(res["pipe"], want, atol=PIPE_TOL)


def test_pipeline_reference_and_bubble_fraction_match_reference():
    params, x = _pipe_inputs()
    got = pipe.pipeline_reference(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                                  {k: torch.from_numpy(v) for k, v in params.items()},
                                  torch.from_numpy(x))
    want = jpipe.pipeline_reference(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                                    {k: jnp.asarray(v) for k, v in params.items()},
                                    jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIPE_TOL)
    for n_micro, n_stages in [(8, 4), (1, 1), (6, 4), (32, 2)]:
        assert pipe.bubble_fraction(n_micro, n_stages) == jpipe.bubble_fraction(
            n_micro, n_stages)


# ---------------------------------------------------------------------------
# BandPilot-ordered meshes
# ---------------------------------------------------------------------------

def _dispatchers(name):
    out = []
    for pkg in (jcore, core):
        cl = {"h100": pkg.h100_cluster, "pod": lambda: pkg.tpu_pod_cluster(2)}[name]()
        sim = pkg.BandwidthSimulator(cl)
        out.append(pkg.BandPilotDispatcher(cl, pkg.IntraHostTables(cl, sim),
                                           pkg.GroundTruthPredictor(sim)))
    return out


@pytest.mark.parametrize("name,avail,k", [
    ("h100", list(range(32)), 16),
    ("h100", [g for g in range(32) if not 8 <= g < 16], 16),
    ("h100", list(range(0, 6)) + list(range(8, 14)), 8),
    ("pod", list(range(16)), 8),
    ("pod", [1, 2, 3, 5, 8, 9, 12, 13, 15], 4),
])
def test_bandpilot_order_and_mesh_choice_match_reference(monkeypatch, name, avail, k):
    jdisp, disp = _dispatchers(name)
    want = jmesh.bandpilot_device_order(jdisp, avail, k)
    assert pmesh.bandpilot_device_order(disp, avail, k) == want
    # the meshes themselves need the devices; the choice does not
    monkeypatch.setattr(jmesh, "make_mesh_from_devices", lambda *a: None)
    monkeypatch.setattr(pmesh, "make_mesh_from_devices", lambda *a: None)
    n = disp.cluster.n_gpus
    _, jchosen = jmesh.bandpilot_mesh(jdisp, list(range(n)), k, (k, 1), ("data", "model"),
                                      avail_ids=avail)
    _, chosen = pmesh.bandpilot_mesh(disp, list(range(n)), k, (k, 1), ("data", "model"),
                                     avail_ids=avail)
    assert chosen == jchosen == want
    _, first = pmesh.bandpilot_mesh(None, list(range(n)), k, (k, 1), ("data", "model"),
                                    avail_ids=avail)
    assert first == avail[:k]


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="needs a world of 256 ranks"):
        pmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs a world of 512 ranks"):
        pmesh.make_production_mesh(multi_pod=True, device_type="cpu")


# ---------------------------------------------------------------------------
# Sharded training on a 2 x 2 mesh
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["gemma-7b", "recurrentgemma-9b"]


def _train_setup(name, mode="fp32"):
    """The config, data and run; the masters' dtype (float64 in the "fp64"
    mode: masters, compute and moments; else fp32, computed in bf16 in the
    "bf16" mode)."""
    cfg = ARCHS[name].reduced()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4, seed=1))
    if mode == "fp64":
        opt = AdamWConfig(lr=TRAIN_LR, weight_decay=0.01, state_dtype=torch.float64)
        run = TrainRunConfig(optimizer=opt, total_steps=TRAIN_STEPS, warmup_steps=2,
                             compute_dtype=None)
        return cfg, data, run, torch.float64
    compute = torch.bfloat16 if mode == "bf16" else torch.float32
    run = TrainRunConfig(optimizer=AdamWConfig(lr=TRAIN_LR, weight_decay=0.01),
                         total_steps=TRAIN_STEPS, warmup_steps=2, compute_dtype=compute)
    return cfg, data, run, torch.float32


def assert_params_close(got, want, mode, outliers=SPLIT_OUTLIERS):
    """Parameters by name after sharded training against the single process's,
    within the mode's bound (the module's docstring); in fp32, all but a
    share ``outliers`` of them within PARAM_ATOL (None: no share)."""
    assert sorted(got) == sorted(want)
    atol = {"fp32": FP32_SPLIT_PARAM_ATOL, "fp64": PARAM_ATOL,
            "bf16_sync": BF16_PARAM_ATOL}[mode]
    beyond = 0
    for n, p in want.items():
        np.testing.assert_allclose(got[n], p, rtol=0, atol=atol, err_msg=n)
        beyond += int(np.sum(np.abs(got[n] - p) > PARAM_ATOL))
    if mode == "fp32" and outliers is not None:
        assert beyond <= outliers * sum(p.size for p in want.values()), beyond


_SHARDED_TRAIN = """
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel, full_state
from repro_torch.train.train_loop import train_loop

mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"), "cpu")
result = {}
for name, (cfg, data, run, dtype) in inputs.items():
    model = ShardedModel(build_model(cfg, device="cpu"), mesh, shd.STRATEGIES["fsdp_tp"]())
    lm, state, hist = train_loop(model, model.init(0, dtype), data.batches(run.total_steps),
                                 run, log_every=1)
    result[name] = {"losses": [h["loss"] for h in hist], "opt_step": state.step,
                    "params": {n: p.numpy() for n, p in full_state(lm).items()}}
"""

@pytest.fixture(scope="module", params=["fp32", "bf16_sync", "fp64"])
def sharded_runs(request, tmp_path_factory):
    """Each arch trained on 4 ranks once a mode, one run an arch (so that no
    run nears its time limit), started when a test first reads it."""
    mode = request.param
    env = {"REPRO_GRAD_SYNC_BF16": "1" if mode == "bf16_sync" else "0"}
    runs = {}

    def ranks(name):
        if name not in runs:
            runs[name] = run_ranks(_SHARDED_TRAIN, 4, tmp_path_factory.mktemp(mode),
                                   inputs={name: _train_setup(name, mode)}, env=env,
                                   timeout=180)
        return runs[name]

    return mode, env, ranks


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_sharded_training_on_2x2_equals_the_single_process(sharded_runs, name, monkeypatch):
    mode, env, ranks = sharded_runs
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, data, run, dtype = _train_setup(name, mode)
    model = build_model(cfg, device="cpu")
    lm, state, hist = train_loop(model, model.init(0, dtype), data.batches(TRAIN_STEPS), run,
                                 log_every=1)
    losses = [h["loss"] for h in hist]
    want = {n: p.detach().numpy() for n, p in lm.named_parameters()}
    for res in ranks(name):
        got = res[name]
        assert got["opt_step"] == state.step == TRAIN_STEPS
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        assert_params_close(got["params"], want, mode)
    assert losses[-1] < losses[0] + 0.1 and np.all(np.isfinite(losses))


_CAST_BARRIER_TRAIN = """
import os
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel, full_state
from repro_torch.train.train_loop import train_loop

mesh = make_mesh_from_devices(range(4), (2, 2), ("data", "model"), "cpu")
result = {}
for barrier in ("0", "1"):
    os.environ["REPRO_CAST_BARRIER"] = barrier
    for name, (cfg, data, run, dtype) in inputs.items():
        model = ShardedModel(build_model(cfg, device="cpu"), mesh, shd.STRATEGIES["fsdp_tp"]())
        lm, state, hist = train_loop(model, model.init(0, dtype), data.batches(run.total_steps),
                                     run, log_every=1)
        result[name, barrier] = {"losses": [h["loss"] for h in hist],
                                 "params": {n: p.numpy() for n, p in full_state(lm).items()}}
"""


@pytest.fixture(scope="module")
def cast_barrier_runs(tmp_path_factory):
    """Both archs trained on 4 ranks in bf16 compute, without and then with
    ``REPRO_CAST_BARRIER=1``, in one call."""
    return run_ranks(_CAST_BARRIER_TRAIN, 4, tmp_path_factory.mktemp("cast_barrier"),
                     inputs={name: _train_setup(name, "bf16") for name in TRAIN_ARCHS},
                     env={"REPRO_GRAD_SYNC_BF16": "0"}, timeout=180)


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_cast_barrier_training_on_2x2_equals_the_knob_off_run(cast_barrier_runs, name):
    """Losses and parameters bit-equal (the module's docstring); the ranks
    agree."""
    for res in cast_barrier_runs:
        off, on = res[name, "0"], res[name, "1"]
        assert on["losses"] == off["losses"]
        assert sorted(on["params"]) == sorted(off["params"])
        for n, p in off["params"].items():
            np.testing.assert_array_equal(on["params"][n], p, err_msg=n)
    assert all(res[name, "1"]["losses"] == cast_barrier_runs[0][name, "1"]["losses"]
               for res in cast_barrier_runs)
