"""The LMs' tensor-parallel layout (`repro_torch.launch.sharding`, `mesh`,
`collectives`, the model's mesh path) against the reference's, on the CPU.

(a) Spec parity, in-process: for every arch, base and tuned, every
    assigned shape and the meshes (16, 16), (2, 16, 16) and (2, 4), the
    port's param / optimizer / batch / cache / logits specs equal the
    reference's leaf for leaf, and `launch_cfg`'s mesh fields and
    `moe_groups` equal the reference's.  The reference runs on a
    `jax.sharding.AbstractMesh` over the port's param shapes (the two trees
    are held equal by tests/test_torch_launch.py), so no device is forced.
(b) The virtual production mesh's `meta` dry-run: a record's per-device
    parameter bytes are the sum of the local blocks its specs give, its
    keys the reference record's, its collectives counted.
(c) One spawned gloo world of 4 ranks on a (2, 2) mesh, shared by the
    module (`tests/torch_lm_tp_ranks.py`, which imports no JAX): reduced
    TinyLlama (tp and dp), Qwen3-MoE (fsdp), Hymba, Mamba2 and Whisper,
    each against the port's single-device run in f32 (the loss, the
    gradients and the params after one AdamW step gathered back to whole,
    the prefill's and 3 decode steps' logits; the tolerances at
    `test_mesh_matches_single_device`), at least one case on the flash
    branch (S = 1152 > 1024); TinyLlama's sharded loss also within 1e-3 of
    the reference's single-device loss (tests/test_sharding.py's bound).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_lm_tp_ranks as ranks
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import LMMesh
from repro_torch.launch.shapes import (
    SHAPES, batch_struct, decode_structs, pad_vocab, params_struct,
)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model"))]


def _ref_cfg(cfg):
    from repro.models.lm.config import ArchConfig
    return ArchConfig(**dataclasses.asdict(cfg))


def _jax_struct(tree):
    """The port's meta tree as the reference's ShapeDtypeStructs (the
    cache's int `pos` as its scalar)."""
    def one(x):
        if isinstance(x, torch.Tensor):
            dt = {torch.float32: np.float32, torch.int32: np.int32,
                  torch.bfloat16: jax.numpy.bfloat16}[x.dtype]
            return jax.ShapeDtypeStruct(tuple(x.shape), dt)
        return jax.ShapeDtypeStruct((), np.int32)
    if isinstance(tree, dict):
        return {k: _jax_struct(v) for k, v in tree.items()}
    return one(tree)


def _as_tuples(tree):
    """The reference's PartitionSpecs (and NamedTuple states) as the port's
    spec tuples."""
    from jax.sharding import PartitionSpec
    if isinstance(tree, PartitionSpec):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(_as_tuples(v) for v in tree)
    raise TypeError(type(tree))


def _port_tuples(tree):
    if isinstance(tree, dict):
        return {k: _port_tuples(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(_port_tuples(v) for v in tree)
    return tree


@pytest.fixture(scope="module")
def structs():
    """Each (arch, tuned) config's padded cfg and its meta params."""
    out = {}
    for arch in ARCH_IDS:
        for tuned in (False, True):
            cfg = pad_vocab(get_config(arch, tuned=tuned))
            out[arch, tuned] = (cfg, params_struct(cfg))
    return out


@pytest.mark.parametrize("sizes,names", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(structs, arch, sizes, names):
    from repro.launch import sharding as RS
    from repro.launch.shapes import InputShape as RShape
    mesh = LMMesh(sizes, names)
    rmesh = AbstractMesh(sizes, names)
    for tuned in (False, True):
        cfg, params = structs[arch, tuned]
        rcfg = _ref_cfg(cfg)
        jparams = _jax_struct(params)
        pspecs = S.param_specs(cfg, mesh, params)
        rp = RS.param_specs(rcfg, rmesh, jparams)
        assert _port_tuples(pspecs) == _as_tuples(rp), (arch, tuned)
        assert _port_tuples(S.opt_specs(cfg, pspecs)) == _as_tuples(
            RS.opt_specs(rcfg, rp))
        for shape in SHAPES.values():
            rshape = RShape(*shape)
            if shape.kind == "decode":
                cache, batch = decode_structs(cfg, shape)
                assert _port_tuples(S.cache_specs(cfg, mesh, cache)) == \
                    _as_tuples(RS.cache_specs(rcfg, rmesh,
                                              _jax_struct(cache))), shape
                assert S.logits_spec(cfg, mesh, shape.global_batch) == tuple(
                    RS.logits_spec(rcfg, rmesh, shape.global_batch))
            else:
                batch = batch_struct(cfg, shape)
            assert _port_tuples(S.batch_specs(cfg, mesh, batch)) == \
                _as_tuples(RS.batch_specs(rcfg, rmesh, _jax_struct(batch)))
            got = S.launch_cfg(cfg, mesh, shape)
            want = RS.launch_cfg(rcfg, rmesh, rshape)
            for f in ("mesh_batch_axes", "mesh_batch_sizes",
                      "mesh_model_axis", "mesh_model_size", "moe_groups"):
                assert getattr(got, f) == getattr(want, f), (f, shape.name)


def test_shard_tree_blocks_tile_the_leaf():
    """Every rank's block of a (2, 4)-mesh leaf, laid side by side, is the
    leaf: `shard_tree` cuts each sharded dim into the rank's block along
    its axes, the first axis the major one, as `named_shardings` says."""
    from repro_torch.launch.compat import named_shardings
    x = torch.arange(8 * 12 * 3).reshape(8, 12, 3)
    spec = (("data", "model"), None, None)
    seen = torch.zeros_like(x)
    for d in range(2):
        for m in range(4):
            mesh = LMMesh((2, 4), ("data", "model"), (d, m))
            got = S.shard_tree({"x": x}, {"x": spec}, mesh)["x"]
            where = named_shardings(mesh, {"x": spec})["x"]
            assert torch.equal(got, x[where.slices(x.shape)])
            assert got.shape == (1, 12, 3)
            seen[d * 4 + m] = got[0]
    assert torch.equal(seen, x)


# ------------------------------------------- (b) the virtual mesh's dry-run --

@pytest.mark.parametrize("arch,shape,mesh", [
    ("tinyllama_1_1b", "prefill_32k", "single"),
    ("qwen3_moe_30b_a3b", "decode_32k", "multi"),
    ("hymba_1_5b", "prefill_32k", "multi")])
def test_mesh_dryrun_record(tmp_path, arch, shape, mesh):
    """A record of the virtual production mesh, counted on meta: the
    reference record's keys (a count time in place of lower / compile
    seconds), 256 or 512 devices, a per-device argument footprint equal to
    the sum of this rank's blocks by the specs (params, the cache, the
    batch), collectives counted in the reference's layout (TinyLlama's
    tensor-parallel step moves bytes over "model"), and the roofline's
    collective term from them."""
    from repro_torch.launch import dryrun
    from test_torch_launch import _ref_record_keys
    rec = dryrun.run_one(arch, shape, mesh=mesh, out_dir=tmp_path)
    want = _ref_record_keys() - {"lower_s", "compile_s"}
    assert set(rec) == want | {"count_s", "fits", "kernels"}
    assert rec["n_devices"] == (256 if mesh == "single" else 512)
    assert rec["mesh"] == ([16, 16] if mesh == "single" else [2, 16, 16])
    lm = dryrun.mesh_of(mesh)
    sh = SHAPES[shape]
    cfg = S.launch_cfg(pad_vocab(get_config(arch)), lm, sh)
    def local_bytes(tree, specs):
        sizes = []

        def one(leaf, spec):
            if isinstance(leaf, torch.Tensor):
                sizes.append(int(np.prod(S.local_shape(tuple(leaf.shape),
                                                       spec, lm)))
                             * leaf.element_size())
        S.map_specs(one, tree, specs)
        return sum(sizes)
    params = params_struct(cfg)
    blocks = local_bytes(params, S.param_specs(cfg, lm, params))
    if sh.kind == "decode":
        cache, batch = decode_structs(cfg, sh)
        blocks += local_bytes(cache, S.cache_specs(cfg, lm, cache))
    else:
        batch = batch_struct(cfg, sh)
    blocks += local_bytes(batch, S.batch_specs(cfg, lm, batch))
    assert rec["memory"]["argument_bytes"] == blocks
    coll = rec["collective_bytes_toplevel"]
    assert set(coll) == {"by_kind", "counts", "weighted_total", "by_axes"}
    assert coll["weighted_total"] == sum(coll["by_kind"].values()) + \
        coll["by_kind"]["all-reduce"] == sum(coll["by_axes"].values())
    assert coll["weighted_total"] > 0 and rec["roofline"]["collective_s"] > 0
    if arch == "tinyllama_1_1b":
        assert coll["by_axes"]["model"] > 0
    assert [p.name for p in tmp_path.iterdir()] == \
        [f"{get_config(arch).name}__{shape}__{mesh}.json"]


def test_mesh_decode_needs_the_cache_length():
    """A rank's cache block does not show the ring's global length, by
    which `cache_specs` places the ring (at m = 16 Hymba's 5 KV heads do
    not divide the axis, so its ring is split on positions), so under a
    mesh `decode_step` refuses to run without `cache_len`, and runs with
    it."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.compat import set_mesh
    from repro_torch.models.lm import model as M
    lm = dryrun.mesh_of("single")
    sh = SHAPES["decode_32k"]
    cfg = dataclasses.replace(S.launch_cfg(
        pad_vocab(get_config("hymba_1_5b")), lm, sh), n_layers=1)
    _, (params, cache, batch) = dryrun.build_step(cfg, sh, mesh=lm)
    with set_mesh(lm):
        with pytest.raises(ValueError, match="cache_len"):
            M.decode_step(cfg, params, cache, batch)
        _, logits = M.decode_step(cfg, params, cache, batch,
                                  cache_len=sh.seq_len)
    assert cache["k"].shape[2] * 16 == M.cache_len_for(cfg, sh.seq_len)
    assert logits.is_meta and logits.shape == (
        sh.global_batch // 16, cfg.vocab // 16)


# ------------------------------------------------- (c) the gloo world --

LR = 3e-4          # make_train_step's AdamW
RTOL = 1e-5        # loss, and each gradient leaf at RTOL of its max |grad|
LOGIT_TOL = 1e-5   # of max |logit|, each serving step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Rank 0's results of every case on the spawned (2, 2) gloo world."""
    return ranks.spawn(tmp_path_factory.mktemp("lm_tp"), list(ranks.CASES))


@pytest.fixture(scope="module")
def single():
    """Every case on one device, here."""
    return {name: ranks.run_case(name) for name in ranks.CASES}


def _leaves(tree):
    from repro_torch.tree import tree_leaves, tree_paths
    return list(zip(tree_paths(tree), tree_leaves(tree)))


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_mesh_matches_single_device(world, single, name):
    """The sharded train step, prefill and decode equal the single-device
    run in f32: the loss at RTOL; AdamW's first moment (0.1 x the
    gradient) per leaf at RTOL of its max; every param after the step
    within 1e-6 + 2 lr delta / (|g| + 1e-8), where delta = RTOL max |g| is
    the gradient's tolerance and 1e-8 AdamW's eps (its first update
    lr g / (|g| + eps) moves by at most lr delta / (|g| + eps) when g moves
    by delta); the prefill's and each decode step's logits, gathered by
    `logits_spec`, at LOGIT_TOL of max |logit|.  Collectives were issued
    and counted."""
    got, want = world[name], single[name]
    assert "error" not in got, got.get("error")
    assert got["loss"] == pytest.approx(want["loss"], rel=RTOL)
    for (path, g), (_, w) in zip(_leaves(got["mu"]), _leaves(want["mu"])):
        top = float(w.abs().max())
        assert float((g - w).abs().max()) <= RTOL * top + 1e-30, path
    for (path, g), (_, w), (_, m) in zip(_leaves(got["params"]),
                                         _leaves(want["params"]),
                                         _leaves(want["mu"])):
        grad = (m / 0.1).abs()
        delta = RTOL * float(grad.max())
        limit = 1e-6 + torch.clamp(2 * LR * delta / (grad + 1e-8), max=2 * LR)
        assert bool(((g - w).abs() <= limit).all()), path
    for g, w in zip(got.get("logits", []), want.get("logits", [])):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= LOGIT_TOL * float(w.abs().max())
    counts = got["train_collectives"]["counts"]
    assert counts["all-reduce"] > 0
    if name == "qwen3_moe_fsdp":        # FSDP: gathers and scatters
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0


def test_tinyllama_sharded_loss_within_the_reference_bound(world):
    """TinyLlama's loss on the (2, 2) mesh against the reference's
    single-device loss on the same params and tokens, at the reference's
    own sharded-vs-single bound (tests/test_sharding.py: 1e-3)."""
    import jax.numpy as jnp
    from repro.models.lm import model as RM
    from repro_torch.interop import params_to_numpy
    data = ranks.inputs("tinyllama_tp")
    rcfg = _ref_cfg(ranks.case_cfg("tinyllama_tp"))
    rparams = jax.tree.map(jnp.asarray, params_to_numpy(data["params"]))
    batch = {"tokens": jnp.asarray(data["batch"]["tokens"].numpy())}
    want = float(jax.jit(lambda p, b: RM.loss_fn(rcfg, p, b))(rparams,
                                                             batch))
    assert abs(world["tinyllama_tp"]["loss"] - want) <= 1e-3


def test_kv_index_keeps_the_local_group():
    """A rank's query heads and the KV heads they read: G' = local Hq /
    local Kh, as the kernel reads head h // G' (hq 32 / kh 8 over 16
    ranks: 2 query heads on 1 KV head; hq 12 / kh 3 over 4: a rank's 3
    heads span two groups, one KV head a query head)."""
    from repro_torch.models.lm.tp import kv_index
    for r in range(16):
        heads, g = kv_index(2 * r, 2, 4)
        assert heads == (r // 2,) and g == 2
    assert kv_index(8, 8, 4) == ((2, 3), 4)
    assert kv_index(3, 3, 4) == ((0, 1, 1), 1)


@pytest.mark.parametrize("name", [n for n in ranks.CASES
                                  if ranks.CASES[n][2] <= 1024])
def test_rank_count_equals_the_virtual_mesh_count(world, name):
    """Rank 0's train step, counted on the CPU inside the gloo world,
    equals the dry-run's count of the same step on `meta` tensors over the
    virtual (2, 2) mesh at rank 0's coordinates: FLOPs, bytes, the
    argument bytes (this rank's blocks and rows), the kernels and every
    collective, by kind and by the axes it crosses.  (The flash case is
    left out: on the CPU the flash branch is the plain blocked loop, not a
    kernel wrapper counted by its formula.)  Bytes are exact, after two
    copies that only one side makes: the SSM's dt-projection gradient
    reaches the CPU's mm transposed, and it copies it (a read and a write
    of this rank's (B, S, H) f32 a layer: Mamba2, Hymba); Whisper's
    sinusoids, made on the CPU, are copied to a meta (or CUDA) device, not
    to the CPU (a read and a write of the (F, D) and (S, D) f32 tables)."""
    from repro_torch.launch import dryrun
    mesh = LMMesh((2, 2), ("data", "model"), (0, 0))
    cfg = S.launch_cfg(ranks.case_cfg(name), mesh,
                       ranks.shapes(name)["train"])
    meta = dryrun.count_step(cfg, ranks.shapes(name)["train"], mesh=mesh)
    got = world[name]["count"]
    for key in ("flops", "argument_bytes", "kernels", "collectives"):
        assert got[key] == meta[key], key
    cfg0, sh = ranks.case_cfg(name), ranks.shapes(name)["train"]
    rows = sh.global_batch // 2              # batch over "data"
    cpu_only = (cfg0.n_layers * 2 * rows * sh.seq_len * cfg0.ssm_heads // 2
                * 4 if cfg0.has_ssm else 0)
    meta_only = (2 * 4 * cfg0.d_model * (cfg0.n_frontend_tokens + sh.seq_len)
                 if cfg0.encoder_layers else 0)
    assert got["bytes_accessed"] - cpu_only == \
        meta["bytes_accessed"] - meta_only
