"""The launch planning path (``repro_torch.launch.{shapes,steps,op_analysis,
roofline,dryrun}``) against the reference's ``repro.launch``, on the CPU.

* The 40-cell table and every input spec (batch, decode cache, encoder
  memory, parameters) equal the reference's at full width, leaf by leaf in
  shape and dtype; the port's per-layer caches are stacked by the
  reference's pattern groups first. No full-width tensor is allocated: the
  port's specs are ``meta`` tensors, the reference's ``ShapeDtypeStruct``s.
* ``model_flops_per_step`` equals the reference's in all 40 cells.
* The op counter counts the same FLOPs, bytes and peak memory for a step
  traced on ``meta`` tensors as for the same step run on real CPU tensors;
  its all-gather bytes equal what ``param_shardings`` implies.
* Each kernel's fake (meta) implementation gives its plain twin's output
  shapes and dtypes, and flash's FLOP formula counts the visible pairs.
* The dry run's CLI runs one full-width cell with no card.

Every fake process group opened here is destroyed on the way out.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.launch import roofline as jroofline
from repro.launch import shapes as jshp
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.rglru import ops as lru_ops, ref as lru_ref
from repro_torch.kernels.rwkv6 import ops as wkv_ops, ref as wkv_ref
from repro_torch.launch import dryrun, op_analysis, roofline, shapes as shp, steps
from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.launch.op_analysis import CollectiveOp, OpCounter
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor_parallel as tp

from test_torch_train import _two_threads  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def _mesh(shape, device_type="cuda"):
    """A fake world of prod(shape) ranks and its ("data", "model") mesh."""
    with dryrun.fake_world(int(np.prod(shape))):
        yield make_mesh_from_devices(range(int(np.prod(shape))), shape, ("data", "model"),
                                     device_type)
    assert not torch.distributed.is_initialized()


def _same_spec(got, want, what):
    assert tuple(got.shape) == tuple(want.shape), (what, tuple(got.shape), want.shape)
    assert got.dtype == _DTYPES[str(want.dtype)], (what, got.dtype, want.dtype)
    assert got.device.type == "meta", what


def _stack_lm_cache(cfg, cache):
    """The port's per-layer caches grouped as the reference's: blocks[i] is
    pattern position i's leaves over the groups, tail[j] the tail's."""
    p = len(cfg.mixer_pattern)
    n_groups, n_tail = cfg.n_groups_and_tail()
    layers = cache["layers"]
    blocks = [{k: (n_groups,) + tuple(v.shape) for k, v in layers[i].items()}
              for i in range(p)]
    for g in range(n_groups):
        for i in range(p):
            for k, v in layers[g * p + i].items():
                assert (v.shape, v.dtype) == (layers[i][k].shape, layers[i][k].dtype)
    tail = [layers[n_groups * p + j] for j in range(n_tail)]
    return blocks, tail


def _assert_cache_equal(cfg, cache, jcache):
    if cfg.is_encoder_decoder:
        assert set(cache) == set(jcache) == {"self", "pos"}
    else:
        assert (set(cache), set(jcache)) == ({"layers", "pos"}, {"blocks", "tail", "pos"})
    assert cache["pos"] == 0 and jcache["pos"].shape == ()
    if cfg.is_encoder_decoder:  # self: one stacked dict over the decoder's layers
        for k, leaf in jcache["self"].items():
            assert len(cache["self"]) == leaf.shape[0]
            for layer in cache["self"]:
                assert tuple(layer[k].shape) == leaf.shape[1:]
                assert layer[k].dtype == _DTYPES[str(leaf.dtype)]
        return
    blocks, tail = _stack_lm_cache(cfg, cache)
    assert len(blocks) == len(jcache["blocks"]) and len(tail) == len(jcache["tail"])
    for got, want in zip(blocks, jcache["blocks"]):
        assert got == {k: tuple(v.shape) for k, v in want.items()}
    for i, want in enumerate(jcache["blocks"]):
        for k, leaf in want.items():
            assert cache["layers"][i][k].dtype == _DTYPES[str(leaf.dtype)]
    for got, want in zip(tail, jcache["tail"]):
        for k, leaf in want.items():
            _same_spec(got[k], leaf, k)


def _param_names(cfg, jshapes):
    """Reference leaf shapes keyed by the port's state-dict names."""
    out = {}
    if cfg.is_encoder_decoder:
        for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes):
            keys = [str(e.key) for e in path]
            if keys[0] in ("enc_blocks", "dec_blocks"):
                for i in range(leaf.shape[0]):
                    out[".".join([keys[0], str(i)] + keys[1:])] = (leaf.shape[1:], leaf.dtype)
            else:
                out[".".join(keys)] = (leaf.shape, leaf.dtype)
        return out
    p = len(cfg.mixer_pattern)
    n_groups, _ = cfg.n_groups_and_tail()
    for k in ("embed", "final_norm", "unembed"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes.get(k, {})):
            out[".".join([k] + [str(e.key) for e in path])] = (leaf.shape, leaf.dtype)
    for i, blk in enumerate(jshapes["blocks"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(blk):
            key = ".".join(str(e.key) for e in path)
            for g in range(n_groups):
                out[f"layers.{g * p + i}.{key}"] = (leaf.shape[1:], leaf.dtype)
    for j, blk in enumerate(jshapes["tail"]):
        for path, leaf in jax.tree_util.tree_leaves_with_path(blk):
            out[f"layers.{n_groups * p + j}." + ".".join(str(e.key) for e in path)] = (
                leaf.shape, leaf.dtype)
    return out


# ---------------------------------------------------------------------------
# The cell table and the specs
# ---------------------------------------------------------------------------

def test_cell_table_is_the_reference():
    assert shp.SHAPES.keys() == jshp.SHAPES.keys()
    for name, cell in shp.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(jshp.SHAPES[name])
    assert shp.LONG_CONTEXT_ARCHS == jshp.LONG_CONTEXT_ARCHS
    assert shp.all_cells() == jshp.all_cells() and len(shp.all_cells()) == 40
    assert shp.runnable_cells() == jshp.runnable_cells()
    for arch, shape in shp.all_cells():
        assert shp.cell_skip_reason(arch, shape) == jshp.cell_skip_reason(arch, shape)


@pytest.mark.parametrize("shape", list(jshp.SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_the_reference(arch, shape):
    """Every cell's batch, cache, token and memory specs at full width (the
    reference builds a prefill batch inline in ``build_prefill_step``)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    cell, jcell = shp.SHAPES[shape], jshp.SHAPES[shape]
    if shp.cell_skip_reason(arch, shape):  # a stated skip, as the reference's
        assert shp.cell_skip_reason(arch, shape) == jshp.cell_skip_reason(arch, shape)
        return
    if cell.kind == "train":
        got, want = shp.train_input_specs(cfg, cell), jshp.train_input_specs(jcfg, jcell)
        assert got.keys() == want.keys()
        for k in want:
            _same_spec(got[k], want[k], k)
        return
    if cell.kind == "prefill":
        B, S = jcell.global_batch, jcell.seq_len
        want = ({"frames": jshp._sds((B, S, jcfg.d_model), jnp.bfloat16)}
                if jcfg.is_encoder_decoder else {"tokens": jshp._sds((B, S), jnp.int32)})
        if jcfg.frontend and not jcfg.is_encoder_decoder:
            want["prefix_embeds"] = jshp._sds((B, jcfg.frontend_seq_len, jcfg.d_model),
                                              jnp.bfloat16)
        got = shp.prefill_input_specs(cfg, cell)
        assert got.keys() == want.keys()
        for k in want:
            _same_spec(got[k], want[k], k)
        _assert_cache_equal(cfg, shp.cache_specs(cfg, B, S, torch.bfloat16),
                            jshp.cache_specs(jcfg, B, S, jnp.bfloat16))
        return
    cache, tokens = shp.decode_input_specs(cfg, cell)
    jcache, jtokens = jshp.decode_input_specs(jcfg, jcell)
    _same_spec(tokens, jtokens, "tokens")
    _assert_cache_equal(cfg, cache, jcache)
    jmem = jshp.memory_specs(jcfg, jcell)
    mem = shp.memory_specs(cfg, cell)
    assert (mem is None) == (jmem is None)
    if jmem is not None:
        _same_spec(mem, jmem, "memory")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch):
    cfg = get_config(arch)
    got = {n: (tuple(p.shape), p.dtype)
           for n, p in shp.param_specs_shapes(cfg, torch.float32).named_parameters()}
    want = _param_names(cfg, jshp.param_specs_shapes(jget_config(arch)))
    assert got.keys() == want.keys()
    for n, (s, dt) in want.items():
        assert got[n] == (tuple(s), _DTYPES[str(dt)]), n
    assert all(p.device.type == "meta" for p in shp.param_specs_shapes(cfg).parameters())


def test_model_flops_per_step_equals_the_reference_in_all_40_cells():
    for arch, shape in shp.all_cells():
        cell = shp.SHAPES[shape]
        for n_chips in (256, 512):
            got = roofline.model_flops_per_step(get_config(arch), cell.global_batch,
                                                cell.seq_len, cell.kind, n_chips)
            want = jroofline.model_flops_per_step(jget_config(arch), cell.global_batch,
                                                  cell.seq_len, cell.kind, n_chips)
            assert got == want, (arch, shape)


# ---------------------------------------------------------------------------
# The op counter
# ---------------------------------------------------------------------------

def test_counter_on_meta_equals_a_real_cpu_run():
    """rwkv6-7b reduced trains through the chunked WKV twin on any device,
    so the meta trace and the CPU run execute the same ops: FLOPs, bytes,
    collectives and peak memory must agree exactly."""
    cfg = ARCHS["rwkv6-7b"].reduced()
    cell = shp.ShapeCell("tiny", 24, 2, "train")
    counts = {}
    with _mesh((1, 1), "cpu") as mesh:
        for dev in ("meta", "cpu"):
            step = steps.build_train_step(cfg, cell, mesh, device=dev, seed=3)
            counts[dev] = dryrun.trace(step)
            params = list(step.args[0].parameters())
            assert all(p.device.type == dev for p in params)
    meta, cpu = counts["meta"], counts["cpu"]
    assert meta["flops"] > 0 and meta["bytes"] > 0 and meta["n_ops"] > 100
    for key in ("flops", "bytes", "nvlink", "nic", "by_kind", "peak_bytes",
                "peak_by_category"):
        assert meta[key] == cpu[key], key
    # ``torch.tensor(x, device=...)`` lifts its constant through one more op
    # (``lift_fresh``, no bytes) on the CPU than on meta
    assert cpu["n_ops"] - meta["n_ops"] == 1
    # a train step's peak holds the fp32 masters and both moments
    cats = meta["peak_by_category"]
    n_bytes = sum(p.numel() * 4 for p in params)
    assert cats["parameters"] >= n_bytes and cats["optimizer"] >= 2 * n_bytes


def test_all_gather_bytes_on_a_2x2_mesh_are_the_gathered_parameters():
    """A prefill gathers every sharded weight once (bf16): a weight whose
    compute splits along ``model`` (attention, the dense MLP, the embedding
    and the head) over the other axis only, so its output is the rank's
    ``model`` block of it (nothing where ``model`` alone shards it); any other
    weight whole, one all-gather whose output is the whole weight on one
    sharded mesh dim, two on both (the first's output is half of it). The
    cache is not gathered (a prefill fills its block where it lies). Besides:
    the sums over ``model`` (after attention and the MLP in each layer, after
    the embedding lookup) and, since 2 KV heads split over model while the
    cache splits its positions, one all-to-all of K and one of V a layer."""
    cfg = ARCHS["internvl2-76b"].reduced()
    cell = shp.ShapeCell("tiny", 32, 4, "prefill")
    with _mesh((2, 2)) as mesh:
        step = steps.build_prefill_step(cfg, cell, mesh)
        costs = dryrun.trace(step)
        specs = shd.param_specs(mesh, shd.STRATEGIES["fsdp_tp"](),
                                shp.param_specs_shapes(cfg, torch.bfloat16))
    want = 0
    for name, p in shp.param_specs_shapes(cfg, torch.bfloat16).named_parameters():
        axes = [a for e in specs[name] if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        if tp.splits_compute(name) and "model" in axes:
            want += (len(axes) - 1) * p.numel() * 2 / 2
        else:
            want += {0: 0, 1: 1, 2: 1.5}[len(axes)] * p.numel() * 2
    B, S, d = 2, cfg.frontend_seq_len + 32, cfg.d_model  # this rank's rows, the prefix too
    sums = (2 * cfg.n_layers * B * S * d + B * 32 * d) * 2
    # the cache (32 slots; the 48 positions fill it as a ring) holds 16 a rank
    to_all = 2 * cfg.n_layers * B * 16 * cfg.n_kv_heads * cfg.head_dim * 2
    assert costs["by_kind"] == {"all-gather": want, "all-reduce": sums, "all-to-all": to_all}
    # every group of a 4-rank mesh lies on one 8-GPU host
    assert costs["nvlink"] == want + sums + to_all and costs["nic"] == 0


def test_split_by_fabric_on_known_groups():
    ops = [CollectiveOp("all-gather", 100, "a", tuple(range(8))),        # one host
           CollectiveOp("all-gather", 10, "b", (0, 8)),                  # two hosts
           CollectiveOp("all-reduce", 7, "c", tuple(range(0, 256, 16))),  # a data column
           CollectiveOp("reduce-scatter", 3, "d", (9, 10, 11))]          # host 1 only
    nvlink, nic, by_kind = op_analysis.split_by_fabric(ops, gpus_per_host=8)
    assert (nvlink, nic) == (103, 17)
    assert by_kind == {"all-gather": 110, "all-reduce": 7, "reduce-scatter": 3}
    assert op_analysis.split_by_fabric(ops, gpus_per_host=16)[:2] == (113, 7)  # b: one host
    assert op_analysis.split_by_fabric(ops, gpus_per_host=256)[:2] == (120, 0)
    summary = op_analysis.collective_summary(ops)
    assert summary == {"n_collectives": 4, "total_bytes": 120, "nvlink_bytes": 103,
                       "nic_bytes": 17, "by_kind": by_kind}


def test_counter_memory_peak_and_categories_on_a_known_graph():
    """Two 1 MiB inputs, a 2 MiB product kept, a 1 MiB temporary freed: the
    peak is the inputs, the kept product and the temporary."""
    x = torch.empty(256, 1024, device="meta")
    counter = OpCounter().track([x], "parameters")
    with counter:
        y = torch.cat([x, x]) * 2   # 2 MiB cat (freed after the mul), 2 MiB y
        z = (x + 1).sum()           # 1 MiB temporary, freed
    mib = 2 ** 20
    assert counter.peak_bytes == mib + 2 * mib + 2 * mib
    cats = counter.peak_by_category()
    assert cats["parameters"] == mib and cats["activations"] == 4 * mib
    assert counter.flops == 0 and counter.n_ops == 4
    # cat reads 2 x 1 MiB, writes 2; mul 2 + 2; add 1 + 1; sum 1 + 4 bytes
    assert counter.bytes == 4 * mib + 4 * mib + 2 * mib + mib + 4
    del y, z


# ---------------------------------------------------------------------------
# The kernels' fake implementations
# ---------------------------------------------------------------------------

FLASH_FAKE_CASES = [
    # B, S_q, S_k, H_q, H_kv, D, dtype, causal, window
    (2, 9, 9, 4, 2, 128, torch.bfloat16, True, None),      # the tensor-core kernel
    (1, 7, 12, 2, 1, 32, torch.float32, False, None),      # the CUDA-core kernel
    (2, 11, 11, 2, 2, 64, torch.bfloat16, True, 4),
]


@pytest.mark.parametrize("case", FLASH_FAKE_CASES)
def test_flash_fake_output_and_flops_match_the_plain_twin(case):
    B, S_q, S_k, Hq, Hkv, D, dt, causal, window = case
    rng = np.random.default_rng(S_q)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)).to(dt)
               for S, H in ((S_q, Hq), (S_k, Hkv), (S_k, Hkv)))
    want = fa_ref.attention_plain(q, k, v, causal=causal, window=window)
    with FlopCounterMode(display=False) as fc:
        got = fa_ops.attention(*(t.to("meta") for t in (q, k, v)), causal=causal, window=window)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    mask = fa_ref.attention_mask(S_q, S_k, causal, window, 0, torch.device("cpu"))
    pairs = int(mask.sum())
    assert fa_ops.visible_pairs(S_q, S_k, causal, window) == pairs
    assert fc.get_total_flops() == 4 * B * Hq * D * pairs


def test_flash_fake_raises_where_the_launch_would():
    q = torch.empty(1, 4, 2, 48, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.attention(q, q, q)
    q = torch.empty(1, 4, 3, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1, 4, 2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.attention(q, k, k)


@pytest.mark.parametrize("pair", [(torch.float32, torch.float32),
                                  (torch.bfloat16, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_fake_output_matches_the_plain_twin(pair, with_h0):
    da, db = pair
    a = torch.rand(2, 5, 8).to(da)
    b = torch.randn(2, 5, 8).to(db)
    h0 = torch.randn(2, 8).to(da) if with_h0 else None
    h, h_final = lru_ops.linear_scan(*(None if t is None else t.to("meta") for t in (a, b, h0)))
    want, want_final = lru_ref.linear_scan_reference(a, b, h0)
    assert (h.device.type, h.shape, h.dtype) == ("meta", want.shape, want.dtype)
    # the kernel keeps h_final in a's dtype (the plain loop in fp32): see ops.py
    assert (h_final.shape, h_final.dtype) == (want_final.shape, da)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_fake_output_matches_the_plain_twin(dt, with_s0):
    B, T, H = 2, 3, 2
    r, k, v, w = (torch.rand(B, T, H, 64).to(dt) for _ in range(4))
    u = torch.rand(H, 64).to(dt)
    s0 = torch.randn(B, H, 64, 64) if with_s0 else None
    y, s_final = wkv_ops.wkv(*(None if t is None else t.to("meta")
                               for t in (r, k, v, w, u, s0)))
    want, want_final = wkv_ref.wkv6_reference(r, k, v, w, u, s0)
    assert (y.device.type, y.shape, y.dtype) == ("meta", want.shape, want.dtype)
    assert (s_final.shape, s_final.dtype) == (want_final.shape, want_final.dtype)


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def test_dryrun_cli_runs_a_full_width_cell_without_a_card(tmp_path):
    out = tmp_path / "cell"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "internvl2-76b",
         "--shape", "train_4k", "--out", str(out)],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    records = [json.loads(line) for line in (tmp_path / "cell.jsonl").read_text().splitlines()]
    assert len(records) == 1
    rec = records[0]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == (
        "internvl2-76b", "train_4k", "16x16", "ok")
    assert rec["strategy"] == "fsdp_tp"
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["by_kind"]["all-gather"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert "internvl2-76b          train_4k     16x16" in proc.stdout  # the table row
    # the model axis splits the compute: each rank does its 16th of the split
    # layers' work (0.551 of the reference's useful share at this cell)
    assert 0.5 < rec["roofline"]["useful_ratio"] < 0.6


def test_whisper_steps_are_all_sharded():
    """whisper-medium at full width on the meta device: the train, prefill
    and serve steps are all a ``ShardedModel``'s, their parameters DTensors,
    the serve step's self caches and memory too."""
    cfg = ARCHS["whisper-medium"]
    with _mesh((2, 2)) as mesh:
        built = [steps.build_train_step(cfg, shp.SHAPES["train_4k"], mesh),
                 steps.build_prefill_step(cfg, shp.SHAPES["prefill_32k"], mesh),
                 steps.build_serve_step(cfg, shp.SHAPES["decode_32k"], mesh)]
    for step in built:
        assert all(isinstance(p, DTensor) for p in step.args[0].parameters()), step.kind
    _, cache, _, memory = built[2].args
    assert all(isinstance(t, DTensor) for c in cache["self"] for t in c.values())
    assert isinstance(memory, DTensor) and memory.shape == (128, 1500, 1024)


def test_dryrun_accounts_for_every_cell():
    skipped = [c for c in shp.all_cells() if shp.cell_skip_reason(*c)]
    assert len(shp.runnable_cells()) + len(skipped) == 40
    assert dryrun.run_cell("gemma-7b", "long_500k", False)[1]["status"] == "skipped"
