"""Expert parallelism on the ``model`` axis (``repro_torch.parallel``)
against the unsplit MoE block and the JAX reference, on the CPU.

Part (i), one process: each rank's share of a reduced MoE layer
(``tensor_parallel.share``, whose sums over ``model`` return the rank's own
term) through ``LayerAxis.moe``, the function the ranks call, for reduced
qwen3-moe (8 experts, top-2, QK-norm) and phi3.5-moe (8 experts, top-2,
layernorm), at B 2 x S 160 (two routing groups, capacity drops). The three
forms the resolver gives the expert leaves:
  * the expert split, W 2 and 4: a rank holds [E/W, d, ff] and computes its
    experts' term;
  * the ff split, E 6 at W 4 (W does not divide E, it divides d_ff): every
    expert's ff/W columns and ``w_down`` rows; the forward only, since its
    gates' gradient is summed over ``model`` before its bf16 rounding, which
    a share alone cannot do (it raises): part (ii) runs its gradients;
  * whole, W 3 (it divides neither): every rank computes the whole block.
Two objectives, each with its own backward: <out, gy> for one upstream
gradient, and the aux term alone (its gradient reaches the router and the
input only, and would be lost beside the gates' in a sum of the two): where
the layer sums, the ranks' outputs and input gradients summed, each expert
leaf's block gradient equal to that block of the unsplit gradient and the
router's gradients summed; where it does not, each rank's equal to the
whole. Outputs within OUT_TOL of the largest,
gradients within MOE_GRAD_TOL of each leaf's largest (the gates' gradient
is rounded to bf16 on both sides). The unsplit block against
``repro.models.moe.moe_block`` on the same weights and the same objective,
with the same tolerances.

Part (ii) is in ``tests/test_torch_tp_train.py`` and
``tests/test_torch_tp_serve.py``: phi3.5-moe and qwen3-moe on 4 gloo ranks,
and phi3.5-moe with 6 experts, split by experts on (data 2, model 2) and by
ff on (model 4).

Part (iii), structure, on the dry run's fake (data 2, model 2) world:
inside the sharded forward each materialized expert leaf is the rank's
[E/2, ...] block, the router's gradient is summed over ``model`` and the
expert leaves' are not, and no collective over ``model`` is an all-gather;
and on a one-rank gloo mesh, sharded serving gives the one process's
prefill bit for bit and its decode logits within 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn.utils.stateless import _reparametrize_module

from repro.configs import ARCHS as JARCHS
from repro.models import moe as jmoe
from repro.models.common import KeyGen
from repro_torch.configs import ARCHS
from repro_torch.launch import shapes as shp, steps
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.fsdp import ShardedModel

from _torch_ranks import run_ranks
from test_torch_launch import _mesh
from test_torch_tp_train import MOE_GRAD_TOL
from test_torch_train import _two_threads  # noqa: F401 (autouse fixture)

MOE = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
OUT_TOL = 1e-6
B, S = 2, 160
PRE = "layers.0.moe."
LEAVES = ("router", "w_up", "w_gate", "w_down")

#   id: (W, config fields replaced, the form of the expert leaves)
FORMS = {
    "experts_W2": (2, {}, "experts"),
    "experts_W4": (4, {}, "experts"),
    "ff_E6_W4": (4, {"n_experts": 6}, "ff"),
    "whole_W3": (3, {}, "whole"),
}


def _pair(name, over, seed=0):
    """(the reference's config and MoE weights, a 1-layer port LM whose MoE
    holds them)."""
    cfg = dataclasses.replace(ARCHS[name].reduced(), n_layers=1, **over)
    jcfg = dataclasses.replace(JARCHS[name].reduced(), n_layers=1, **over)
    p = jmoe.init_moe(KeyGen(jax.random.PRNGKey(seed)), jcfg, jnp.float32)
    lm = build_model(cfg, device="cpu").init(seed)
    lm.layers[0].moe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    return jcfg, p, lm.requires_grad_(True)


def _inputs(cfg):
    rng = np.random.default_rng(1)
    return (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))


def _within(got, want, tol, what):
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= tol * scale, (what, err, scale)


def _grads(out, aux, gy, inputs):
    """{objective: gradients of ``inputs``, the input and the router first}:
    of <out, gy>, and of the aux term (which reaches those two only)."""
    grads = torch.autograd.grad((out * gy).sum(), inputs, retain_graph=True)
    return {"output": grads,
            "aux": torch.autograd.grad(aux, inputs[:2])}


def _rank_shares(lm, W, x, gy, backward=True):
    """Each rank's (axis, out, aux, {objective: (input gradient, {leaf:
    gradient of its block})}) for ``LayerAxis.moe`` on its weight blocks, the
    same input and upstream gradient (no gradients where not ``backward``)."""
    names = [PRE + leaf for leaf in LEAVES if hasattr(lm.layers[0].moe, leaf)]
    ranks = []
    for r in range(W):
        axis, params, _ = tp.share(lm, None, r, W)
        blocks = {n: params[n].detach().clone().requires_grad_() for n in names}
        h = x.clone().requires_grad_()
        with _reparametrize_module(lm, blocks):
            out, aux = axis.layer(0).moe(lm.layers[0].moe, h, with_aux=True)
        grads = {}
        if backward:
            grads = {k: (g[0], dict(zip(names, g[1:])))
                     for k, g in _grads(out, aux, gy, [h] + list(blocks.values())).items()}
        ranks.append((axis, out.detach(), aux.detach(), grads))
    return names, ranks


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("name", MOE)
def test_summed_expert_shares_equal_the_unsplit_block_and_the_reference(name, form):
    W, over, kind = FORMS[form]
    jcfg, p, lm = _pair(name, over)
    cfg, moe = lm.cfg, lm.layers[0].moe
    xn, gyn = _inputs(cfg)
    x, gy = torch.from_numpy(xn), torch.from_numpy(gyn)

    # the unsplit block against the reference, both objectives
    xw = x.clone().requires_grad_()
    out, aux = moe(xw)
    names = [PRE + leaf for leaf in LEAVES if hasattr(moe, leaf)]
    want = {k: (g[0], dict(zip(names, g[1:])))
            for k, g in _grads(out, aux, gy,
                               [xw] + [lm.get_parameter(n) for n in names]).items()}
    jout, jaux = jmoe.moe_block(p, jcfg, jnp.asarray(xn))
    _within(out.detach(), torch.from_numpy(np.array(jout)), OUT_TOL, "unsplit output")
    assert abs(float(aux.detach()) - float(jaux)) <= OUT_TOL * abs(float(jaux))
    for k, pick in (("output", lambda o, a: jnp.sum(o * gyn)), ("aux", lambda o, a: a)):
        jgp, jgx = jax.grad(lambda p, x: pick(*jmoe.moe_block(p, jcfg, x)),
                            argnums=(0, 1))(p, jnp.asarray(xn))
        dx, dleaves = want[k]
        for n, g in [("input", dx)] + list(dleaves.items()):
            ref = torch.from_numpy(np.array(jgx if n == "input" else jgp[n[len(PRE):]]))
            assert float(ref.abs().max()) > 0, (k, n)
            _within(g, ref, MOE_GRAD_TOL, f"unsplit {n}, {k}")
    if kind == "experts":  # capacity drops choices, so the block mask meets dropped ones
        assert int((~moe._route(x.reshape(-1, cfg.d_model), 256).keep).sum()) > 0

    # the ff split's gates' gradient is summed over model before its rounding,
    # which a share alone cannot do: its gradients are checked on the gloo ranks
    # (``tests/test_torch_tp_train.py``, phi3.5-moe with E 6 on (model 4))
    names, ranks = _rank_shares(lm, W, x, gy, backward=kind != "ff")
    layer = ranks[0][0].layer(0)
    split = layer.experts
    assert layer.moe_sum == (kind != "whole")
    if kind == "experts":
        assert split.dim == 0 and split.hi - split.lo == cfg.n_experts // W
    elif kind == "ff":
        assert split.dim == 2 and split.hi - split.lo == cfg.d_ff // W
    else:
        assert split is None
    for _, _, a, _ in ranks:  # the aux term whole on every rank
        assert float(a) == float(aux.detach())
    if layer.moe_sum:
        _within(sum(o for _, o, _, _ in ranks), out.detach(), OUT_TOL, "output")
    else:
        for _, o, _, _ in ranks:
            _within(o, out.detach(), OUT_TOL, "output")
    if kind == "ff":
        axis, params, _ = tp.share(lm, None, 0, W)
        with _reparametrize_module(lm, {n: params[n] for n in names}):
            o, a = axis.layer(0).moe(moe, x.clone().requires_grad_(), with_aux=True)
        with pytest.raises(NotImplementedError, match="summed gradient of the gates"):
            ((o * gy).sum() + a).backward()
        return
    for k, (dx, dleaves) in want.items():
        got = [g[k] for *_, g in ranks]
        if layer.moe_sum:
            _within(sum(d for d, _ in got), dx, MOE_GRAD_TOL, ("input", k))
        else:
            for d, _ in got:
                _within(d, dx, MOE_GRAD_TOL, ("input", k))
        for n, g in dleaves.items():
            splits = [axis.split(n) for axis, *_ in ranks]
            sums = {axis.sums_gradient(n) for axis, *_ in ranks}
            assert sums == {layer.moe_sum and n.endswith("router")}, n
            if splits[0] is not None:  # a split leaf: the rank's block
                for sp, (_, blocks) in zip(splits, got):
                    assert blocks[n].shape[sp.dim] == sp.hi - sp.lo
                    _within(blocks[n], g.narrow(sp.dim, sp.lo, sp.hi - sp.lo), MOE_GRAD_TOL,
                            (n, k))
            elif sums.pop():
                _within(sum(blocks[n] for _, blocks in got), g, MOE_GRAD_TOL, (n, k))
            else:
                for _, blocks in got:
                    _within(blocks[n], g, MOE_GRAD_TOL, (n, k))


@pytest.mark.parametrize("W", [1, 2, 4])
def test_a_one_expert_block_routes_as_one_process(W):
    """``MoE(..., experts=(lo, hi))`` of every block, summed, is the unsplit
    block; the whole range is the unsplit block bit for bit."""
    _, _, lm = _pair(MOE[1], {})
    moe = lm.layers[0].moe
    x = torch.from_numpy(_inputs(lm.cfg)[0])
    E = lm.cfg.n_experts
    with torch.no_grad():
        want, want_aux = moe(x)
        terms = []
        for r in range(W):
            lo, hi = r * E // W, (r + 1) * E // W
            block = {n: getattr(moe, n)[lo:hi] for n in LEAVES[1:] if hasattr(moe, n)}
            with _reparametrize_module(moe, block):
                out, aux = moe(x, experts=(lo, hi))
            assert torch.equal(aux, want_aux)
            terms.append(out)
    if W == 1:
        assert torch.equal(terms[0], want)
    _within(sum(terms), want, OUT_TOL, "summed blocks")


def test_expert_leaves_take_the_resolved_spec():
    """Under ``fsdp_tp`` at 2, 4, 8 and 16 model ranks qwen3-moe's and
    phi3.5-moe's expert leaves split on dim 0; an E the axis does not divide
    takes the ff split, and neither stays whole."""
    for name in MOE:
        full = ARCHS[name]
        meta = shp.param_specs_shapes(dataclasses.replace(full, n_layers=1), torch.float32)
        shapes = tp.param_shapes(meta)
        for M in (2, 4, 8, 16):
            axis = tp.ModelAxis({"data": 16, "model": M}, shd.STRATEGIES["fsdp_tp"](), shapes,
                                None, tp.Shares(), coord={"data": 0, "model": M - 1})
            layer = axis.layer(0)
            assert layer.experts == shd.Split(0, ("model",), full.n_experts - full.n_experts // M,
                                              full.n_experts)
            assert axis.split(PRE + "w_down").dim == 0 and axis.split(PRE + "router") is None
            assert axis.sums_gradient(PRE + "router")
    cfg = ARCHS[MOE[0]].reduced()
    for over, M, dim in (({"n_experts": 6}, 4, 2), ({}, 3, None)):
        meta = shp.param_specs_shapes(dataclasses.replace(cfg, **over), torch.float32)
        axis = tp.ModelAxis({"model": M}, shd.STRATEGIES["tp_only"](), tp.param_shapes(meta),
                            None, tp.Shares(), coord={"model": 0})
        split = axis.layer(0).experts
        assert (None if split is None else split.dim) == dim
        assert axis.sums_gradient(PRE + "router") == (dim is not None)


# ---------------------------------------------------------------------------
# Part (iii): the sharded step's structure on the dry run's fake world
# ---------------------------------------------------------------------------

def test_a_sharded_step_materializes_the_rank_experts_and_sums_only_the_router(monkeypatch):
    """Reduced qwen3-moe (8 experts) on (data 2, model 2), one train step on
    meta tensors: each expert leaf comes out of the materialize hook as the
    rank's [4, ...] block, the router's gradient is summed over ``model``
    and the experts' are not, and over ``model`` nothing is all-to-all and
    no weight is gathered: the stream's sequence splits over it, so its
    all-gathers and reduce-scatters move a rank's [2, 64, d] stream in bf16
    (the rest are all-reduces)."""
    cfg = ARCHS[MOE[1]].reduced()
    seen = {}
    weights = ShardedModel._weights

    def recording(self, axis, row_axes):
        weight = weights(self, axis, row_axes)

        def record(name, p):
            out = weight(name, p)
            if ".moe." in name:
                seen[name] = (tuple(out.shape), axis.sums_gradient(name))
            return out
        return record

    monkeypatch.setattr(ShardedModel, "_weights", recording)
    cell = shp.ShapeCell("tiny", 64, 4, "train")
    with _mesh((2, 2)) as mesh:
        step = steps.build_train_step(cfg, cell, mesh)
        counter = OpCounter()
        with counter:
            step()
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    want = {"router": ((d, E), True), "w_up": ((E // 2, d, ff), False),
            "w_gate": ((E // 2, d, ff), False), "w_down": ((E // 2, ff, d), False)}
    assert seen == {f"layers.{i}.moe.{leaf}": v for i in range(cfg.n_layers)
                    for leaf, v in want.items()}
    over_model = [op for op in counter.collectives if op.ranks == (0, 1)]
    assert {op.kind for op in over_model} == {"all-gather", "reduce-scatter", "all-reduce"}
    assert {op.bytes for op in over_model if op.kind != "all-reduce"} == {2 * 64 * d * 2}


_ONE_RANK = """
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.fsdp import ShardedModel

cfg, tokens, steps = inputs
mesh = make_mesh_from_devices(range(world), (1, 1), ("data", "model"), "cpu")
one = build_model(cfg, device="cpu")
lm = one.init(0)
with torch.no_grad():
    cache = one.init_cache(tokens.shape[0], 64, torch.float32)
    logits, cache = one.prefill(lm, {"tokens": tokens}, cache)
    want = [logits]
    for _ in range(steps):
        logits, cache = one.decode_step(lm, cache, logits.argmax(-1))
        want.append(logits)
    model = ShardedModel(one, mesh, shd.STRATEGIES["fsdp_tp"]())
    model.shard(lm)
    experts = model.model_axis(lm, None, (), 1).layer(0).experts
    cache = model.init_cache(tokens.shape[0], 64, torch.float32)
    logits, cache = model.prefill(lm, {"tokens": tokens}, cache)
    got = [logits.full_tensor()]
    for w in want[:-1]:  # fed the one process's tokens
        logits, cache = model.decode_step(lm, cache, w.argmax(-1))
        got.append(logits.full_tensor())
result = {"experts": experts, "prefill_equal": bool(torch.equal(got[0], want[0])),
          "got": torch.stack(got), "want": torch.stack(want)}
"""


def test_a_one_rank_mesh_serves_as_one_process(tmp_path):
    """On a (data 1, model 1) mesh every split is one block: the MoE's one
    block of all its experts, and the cache's sequence split over one rank,
    whose one shard holds every position (decode takes the plain path over
    it, as the one process does). The prefill
    gives the one process's logits bit for bit; 6 decode steps fed the one
    process's greedy tokens give its logits within 2e-4 of the largest and
    its tokens."""
    cfg = ARCHS[MOE[1]].reduced()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 24)))
    (res,) = run_ranks(_ONE_RANK, 1, tmp_path, inputs=(cfg, tokens, 6), timeout=120)
    assert res["experts"] == shd.Split(0, ("model",), 0, cfg.n_experts)
    assert res["prefill_equal"]
    for step, (got, want) in enumerate(zip(res["got"], res["want"])):
        _within(got, want, 2e-4, ("decode step", step))
        assert torch.equal(got.argmax(-1), want.argmax(-1)), step


_MESH_SHARES = """
from torch.nn.utils.stateless import _reparametrize_module
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.moe import MoE
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

mesh = make_mesh_from_devices(range(world), (world,), ("model",), "cpu")
result = {}
for form, cfg, weights, x, gy in inputs:
    moe = MoE(cfg, "cpu", torch.float32)
    moe.load_state_dict({n: torch.from_numpy(w) for n, w in weights.items()})
    shapes = {"layers.0.moe." + n: tuple(p.shape) for n, p in moe.named_parameters()}
    axis = tp.ModelAxis(mesh, shd.STRATEGIES["tp_only"](), shapes, None,
                        tp.MeshCollectives(mesh))
    blocks = {}
    for n, p in moe.named_parameters():
        sp = axis.split("layers.0.moe." + n)
        t = p if sp is None else p.narrow(sp.dim, sp.lo, sp.hi - sp.lo)
        blocks[n] = t.detach().clone().requires_grad_()
    h = torch.from_numpy(x).requires_grad_()
    with _reparametrize_module(moe, blocks):
        out, aux = axis.layer(0).moe(moe, h, with_aux=True)
    names = list(blocks)
    g = torch.autograd.grad((out * torch.from_numpy(gy)).sum(), [h] + list(blocks.values()),
                            retain_graph=True)
    ga = torch.autograd.grad(aux, [h, blocks["router"]])
    result[form] = {"out": out.detach().numpy(), "aux": float(aux),
                    "output": {"input": g[0].numpy(),
                               **{n: t.numpy() for n, t in zip(names, g[1:])}},
                    "aux_grads": {"input": ga[0].numpy(), "router": ga[1].numpy()}}
"""


def test_mesh_shares_on_gloo_ranks_equal_the_unsplit_block(tmp_path):
    """Part (i) on 4 gloo ranks of a (model 4) mesh, through the mesh's own
    collectives: the expert split (8 experts) and the ff split (6 experts,
    whose gates' gradient is summed over ``model`` before its bf16 rounding:
    rounding each rank's term apart parts from one process by about 2e-3 of
    the router's largest gradient here). Each rank's output and input
    gradient are whole, the router's gradient is its term (summed here),
    each expert leaf's its block's."""
    cases, want = [], {}
    for form, over in (("experts", {}), ("ff", {"n_experts": 6})):
        _, p, lm = _pair(MOE[1], over)
        moe = lm.layers[0].moe
        xn, gyn = _inputs(lm.cfg)
        cases.append((form, lm.cfg, {n: t.detach().numpy() for n, t in moe.named_parameters()},
                      xn, gyn))
        xw = torch.from_numpy(xn).requires_grad_()
        out, aux = moe(xw)
        names, leaves = zip(*moe.named_parameters())
        g = _grads(out, aux, torch.from_numpy(gyn), [xw] + list(leaves))
        want[form] = (out.detach(), float(aux.detach()),
                      {"output": {"input": g["output"][0], **dict(zip(names, g["output"][1:]))},
                       "aux_grads": {"input": g["aux"][0], "router": g["aux"][1]}})
    results = run_ranks(_MESH_SHARES, 4, tmp_path, inputs=cases, timeout=120)
    for (form, cfg, *_), (out, aux, grads) in zip(cases, want.values()):
        for r, res in enumerate(results):
            got = res[form]
            _within(torch.from_numpy(got["out"]), out, OUT_TOL, (form, "output"))
            assert abs(got["aux"] - aux) <= OUT_TOL * aux
            for k in ("output", "aux_grads"):
                _within(torch.from_numpy(got[k]["input"]), grads[k]["input"], MOE_GRAD_TOL,
                        (form, k, "input"))
                if k == "output":
                    for n in ("w_up", "w_gate", "w_down"):
                        dim, n_all = ((0, cfg.n_experts) if form == "experts" else
                                      (1 if n == "w_down" else 2, cfg.d_ff))
                        lo, hi = r * n_all // 4, (r + 1) * n_all // 4
                        _within(torch.from_numpy(got[k][n]), grads[k][n].narrow(dim, lo, hi - lo),
                                MOE_GRAD_TOL, (form, n))
        for k in ("output", "aux_grads"):
            router = sum(torch.from_numpy(res[form][k]["router"]) for res in results)
            _within(router, grads[k]["router"], MOE_GRAD_TOL, (form, k, "router"))
