"""The port's launch layer (`repro_torch.launch`: roofline, compat, shapes,
dryrun, hillclimb) against the reference's `repro.launch`, on the CPU.

Shapes, applicability, vocab padding, the meta structs (against the
reference's `ShapeDtypeStruct`s and `jax.eval_shape`) and `model_flops`
are held equal exactly for all ten archs.  The counting mode is held to
closed forms on small ops and to each kernel's formula through its
wrapper, on `meta` and on the CPU; a reduced LM step counted on `meta`
equals the same step run on the CPU (FLOPs, bytes, live-byte peak,
exactly); the 1- / 2-layer assembly equals a direct count at 3 layers
(FLOPs and bytes exactly, compute seconds to 1e-12 relative: a sum of
per-layer quotients in another order).  The reference's `dryrun.py` and
`hillclimb.py` set XLA_FLAGS when imported, so their record keys and
variants are read from their source, not imported.
"""
import ast
import dataclasses
import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_roofline
from repro.launch import shapes as jax_shapes
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.ce_loss import ce_loss
from repro_torch.kernels.cohort_gather import cohort_gather
from repro_torch.kernels.delta_codec import delta_codec_roundtrip
from repro_torch.kernels.flash_attention import flash_attention_gqa
from repro_torch.kernels.prefix_avg import prefix_avg
from repro_torch.kernels.weighted_avg import weighted_avg
from repro_torch.launch import compat, dryrun, hillclimb, roofline, shapes
from repro_torch.launch.compat import Count
from repro_torch.launch.roofline import (
    BF16_PEAK_FLOPS, F32_PEAK_FLOPS, HBM_BYTES_PER_S, TF32_PEAK_FLOPS,
    band_pairs, bound_s, kernel_cost,
)
from repro_torch.tree import tree_leaves, tree_paths

ROOT = Path(__file__).resolve().parent.parent
REF_LAUNCH = ROOT / "src" / "repro" / "launch"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Six test files run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dt(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _ref_struct_tree(tree) -> dict:
    """{path: (shape, dtype)} of a reference pytree of structs / arrays."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(x.shape), str(x.dtype)) for path, x in flat}


def _port_struct_tree(tree) -> dict:
    return {p: (tuple(x.shape), _dt(x))
            for p, x in zip(tree_paths(tree), tree_leaves(tree))}


# ---------------------------------------------------------------- shapes --

def test_shapes_registry_equals_reference():
    assert {k: tuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: tuple(v) for k, v in jax_shapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicability_and_vocab_padding_equal_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    for name in shapes.SHAPES:
        assert shapes.shape_applicable(cfg, shapes.SHAPES[name]) == \
            jax_shapes.shape_applicable(ref, jax_shapes.SHAPES[name])
    assert shapes.pad_vocab(cfg).vocab == jax_shapes.pad_vocab(ref).vocab
    assert shapes.pad_vocab(cfg, 7).vocab == \
        jax_shapes.pad_vocab(ref, 7).vocab


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_structs_equal_reference(arch):
    """batch, decode and params structs: the same leaves, shapes and
    dtypes as the reference's ShapeDtypeStructs / eval_shape, on meta (the
    cache's `pos` is the port's Python int, the reference's int32
    scalar)."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    for name in ("train_4k", "prefill_32k"):
        got = shapes.batch_struct(cfg, shapes.SHAPES[name])
        want = jax_shapes.batch_struct(ref, jax_shapes.SHAPES[name])
        assert all(t.is_meta for t in got.values())
        assert _port_struct_tree(got) == _ref_struct_tree(want)
    for name in ("decode_32k", "long_500k"):
        cache, batch = shapes.decode_structs(cfg, shapes.SHAPES[name])
        rcache, rbatch = jax_shapes.decode_structs(ref,
                                                   jax_shapes.SHAPES[name])
        assert isinstance(cache.pop("pos"), int)
        rcache = dict(rcache)
        assert rcache.pop("pos").shape == ()
        assert all(t.is_meta for t in cache.values())
        assert _port_struct_tree(cache) == _ref_struct_tree(rcache)
        assert _port_struct_tree(batch) == _ref_struct_tree(rbatch)
    got = shapes.params_struct(cfg)
    assert all(t.is_meta for t in tree_leaves(got))
    assert _port_struct_tree(got) == _ref_struct_tree(
        jax_shapes.params_struct(ref))
    specs = shapes.input_specs(cfg, "decode_32k")
    assert set(specs) == {"cache", "batch"}


def test_meta_init_draws_nothing():
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    params = shapes.params_struct(get_config("kimi_k2_1t_a32b"))
    assert sum(t.numel() for t in tree_leaves(params)) > 10 ** 12
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    cfg, ref = get_config(arch), jax_get_config(arch)
    for name, shape in shapes.SHAPES.items():
        assert roofline.model_flops(cfg, shape) == \
            jax_roofline.model_flops(ref, jax_shapes.SHAPES[name])


# ----------------------------------------------------------------- count --

def test_count_closed_forms():
    """An f32 and a bf16 matmul (2 M N K FLOPs at their dtype's peak, A, B
    and C bytes), a view (0 bytes), an in-place add (its mutated argument
    read and written, the other read), and the live-byte peak."""
    a = torch.ones((8, 16))
    b = torch.ones((16, 4))
    with Count() as c:
        c.track(a, b)
        y = a @ b
        z = a.bfloat16() @ b.bfloat16()
        v = a.view(16, 8)
        y.add_(y)
        del z
    assert c.flops_by_peak == {F32_PEAK_FLOPS: 2 * 8 * 16 * 4,
                               BF16_PEAK_FLOPS: 2 * 8 * 16 * 4}
    assert math.isclose(c.compute_s, 2 * 8 * 16 * 4 * (
        1 / F32_PEAK_FLOPS + 1 / BF16_PEAK_FLOPS), rel_tol=1e-15)
    mm = (8 * 16 + 16 * 4 + 8 * 4) * 4
    casts = (8 * 16 + 16 * 4) * (4 + 2)
    assert c.bytes == mm + casts + mm // 2 + 3 * 8 * 4 * 4
    assert c.argument_bytes == (8 * 16 + 16 * 4) * 4
    # the arguments, y, and the bf16 casts with z at once
    assert c.peak_bytes == c.argument_bytes + 8 * 4 * 4 + \
        (8 * 16 + 16 * 4 + 8 * 4) * 2
    assert c.live == c.argument_bytes + 8 * 4 * 4
    assert v.shape == (16, 8)
    assert compat.cost_analysis_of(c) == {"flops": c.flops,
                                          "bytes_accessed": float(c.bytes)}
    assert compat.memory_stats_of(c) == {
        "argument_bytes": c.argument_bytes, "temp_bytes": c.temp_bytes,
        "peak_bytes": c.peak_bytes}


def test_compiled_probes_count_meta_copies():
    """`compiled_flops` / `compiled_memory_stats` count on meta copies of
    the arguments: the same numbers as the CPU run's count."""
    a, b = torch.randn((32, 64)), torch.randn((64, 8))

    def fn(x, y):
        return torch.relu(x @ y).sum()

    want = compat.count_call(fn, a, b)
    assert compat.compiled_flops(fn, a, b) == want.flops == 2 * 32 * 64 * 8
    assert compat.compiled_memory_stats(fn, a, b) == \
        compat.memory_stats_of(want)


# ---------------------------------------------------- the kernels' costs --

# phase 3's main-path calls: the 784-200-100-10 MLP (D = 178,110), M = 5,
# R = 250 walks; 1250 prefix models x 500 validation rows x 10 classes;
# the four client stacks (N = 50, 158 rows of 784 f32 pixels, int64
# labels, int64 counts, f32 sigma); the flash layers of Danube (B = 4,
# S = 8192, 32 / 8 heads of 120, window 4096) and TinyLlama (B = 4,
# S = 2048, 32 / 4 heads of 64)
D_MLP = 784 * 200 + 200 + 200 * 100 + 100 + 100 * 10 + 10
ROW_BYTES = 158 * 784 * 4 + 158 * 8 + 8 + 4
DANUBE = dict(b=4, s=8192, t=8192, hq=32, kh=8, hd=120, window=4096)
TINY = dict(b=4, s=2048, t=2048, hq=32, kh=4, hd=64, window=0)

PHASE3 = [
    ("prefix_avg", dict(r=250, m=5, d=D_MLP), 0.2669),
    ("ce_loss", dict(models=1250, rows=500, v=10), 0.0082),
    ("cohort_gather", dict(m=5, row_bytes=ROW_BYTES), 0.0015),
    ("delta_codec", dict(m=5, d=D_MLP), 0.0023),
    ("weighted_avg", dict(r=1250, m=5, d=D_MLP), 0.2669),
    ("flash_attention", dict(DANUBE, itemsize=2), 1.5635),
    ("flash_attention", dict(DANUBE, itemsize=4), 9.3716),
    ("flash_attention_bwd", dict(TINY, itemsize=2), 0.1738),
    ("flash_attention_bwd", dict(TINY, itemsize=4), 1.0417),
]


@pytest.mark.parametrize("name,shape,bound_ms", PHASE3,
                         ids=[f"{n}-{s.get('itemsize', 4)}"
                              for n, s, _ in PHASE3])
def test_kernel_cost_closed_forms_and_phase3_bounds(name, shape, bound_ms):
    flops, n_bytes, peak = kernel_cost(name, **shape)
    if name == "prefix_avg":
        r, m, d = 250, 5, D_MLP
        want = (3 * r * m * d, 4 * m * d * (1 + r) + 8 * r * m + 4 * m,
                F32_PEAK_FLOPS)
    elif name == "ce_loss":
        want = (4 * 1250 * 500 * 10, 4 * 1250 * 500 * 10 + 8 * 500
                + 4 * 1250 * 500, F32_PEAK_FLOPS)
    elif name == "cohort_gather":
        want = (0, 2 * 5 * ROW_BYTES + 5 * 8, F32_PEAK_FLOPS)
    elif name == "delta_codec":
        want = (8 * 5 * D_MLP, 11 * D_MLP * 4, F32_PEAK_FLOPS)
    elif name == "weighted_avg":
        want = (2 * 1250 * 5 * D_MLP, 4 * (5 * D_MLP + 1250 * 5
                                           + 1250 * D_MLP), F32_PEAK_FLOPS)
    else:
        sh = DANUBE if name == "flash_attention" else TINY
        pairs = band_pairs(sh["s"], sh["t"], sh["window"]) * 4 * 32
        # a causal band: the first `window` rows see q + 1 keys, the rest
        # `window`
        w = sh["window"] or sh["s"]
        assert pairs == 4 * 32 * (w * (w + 1) // 2 + (sh["s"] - w) * w)
        size = shape["itemsize"]
        work = 4 * sh["hd"] * pairs * (1 if name == "flash_attention"
                                       else 2.5)
        q_side = sh["b"] * sh["s"] * sh["hq"] * sh["hd"]
        kv_side = sh["b"] * sh["t"] * sh["kh"] * sh["hd"]
        moved = ((2 * q_side + 2 * kv_side) * size
                 if name == "flash_attention"
                 else (4 * q_side + 4 * kv_side) * size + 4 * 32 * 2048 * 4)
        want = ((work, moved, BF16_PEAK_FLOPS) if size == 2
                else (3 * work, moved, TF32_PEAK_FLOPS))
    assert (flops, n_bytes, peak) == want
    seconds, by = bound_s(flops, n_bytes, peak)
    assert round(seconds * 1e3, 4) == bound_ms
    assert by == ("operations" if name.startswith("flash") else "bytes")
    assert seconds == max(flops / peak, n_bytes / HBM_BYTES_PER_S)


def test_band_pairs_counts_the_mask():
    for s_len, t_len, window, causal in ((7, 7, 0, True), (5, 9, 3, True),
                                         (6, 4, 0, False), (8, 8, 2, False)):
        q = np.arange(s_len)[:, None]
        k = np.arange(t_len)[None, :]
        mask = np.ones((s_len, t_len), bool)
        if causal:
            mask &= k <= q
        if window:
            mask &= k > q - window
        assert band_pairs(s_len, t_len, window, causal) == mask.sum()


def _wrapper_calls():
    """(name, formula shapes, its inputs on a device, a call of the
    wrapper on them)."""
    m, r, d = 3, 4, (6 * 5 + 5)

    def stack(dev):
        g = torch.Generator().manual_seed(0)
        tree = {"w": torch.randn((m, 6, 5), generator=g),
                "b": torch.randn((m, 5), generator=g)}
        return {k: v.to(dev) for k, v in tree.items()}

    def perms(dev):
        return torch.stack([torch.randperm(m, generator=torch.Generator()
                                           .manual_seed(i))
                            for i in range(r)]).to(dev)

    def flash_args(dev, grad=False):
        g = torch.Generator().manual_seed(1)
        return [torch.randn(s, generator=g).to(dev).requires_grad_(grad)
                for s in ((2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16))]

    def flash_bwd(q, k, v):
        flash_attention_gqa(q, k, v, window=3).sum().backward()

    flash_shape = dict(b=2, s=8, t=8, hq=4, kh=2, hd=16, itemsize=4,
                       window=3)
    return [
        ("prefix_avg", dict(r=r, m=m, d=d),
         lambda dev: (stack(dev), perms(dev), torch.ones(m, device=dev)),
         prefix_avg),
        ("weighted_avg", dict(r=r, m=m, d=d),
         lambda dev: (stack(dev), torch.ones((r, m), device=dev)),
         weighted_avg),
        ("cohort_gather", dict(m=2, row_bytes=d * 4),
         lambda dev: (stack(dev), np.array([2, 0])), cohort_gather),
        ("delta_codec", dict(m=m, d=d),
         lambda dev: (stack(dev), {k: v[0] for k, v in stack(dev).items()},
                      "quant8"), delta_codec_roundtrip),
        ("ce_loss", dict(models=r, rows=6, v=10),
         lambda dev: (torch.randn((r, 6, 10)).to(dev),
                      torch.arange(6, device=dev) % 10), ce_loss),
        ("flash_attention", flash_shape, flash_args,
         lambda q, k, v: flash_attention_gqa(q, k, v, window=3)),
        ("flash_attention_bwd", flash_shape,
         lambda dev: flash_args(dev, True), flash_bwd),
    ]


@pytest.mark.parametrize("name,shape,make,call", _wrapper_calls(),
                         ids=[c[0] for c in _wrapper_calls()])
def test_wrapper_counts_its_formula_on_meta_and_cpu(name, shape, make,
                                                     call):
    """Each wrapper adds its kernel's formula once and mutes its own aten
    ops, on the meta route and on the CPU's plain version alike; the two
    counts are equal, and no kernel launch is counted."""
    counts = {}
    before = dict(kernels.LAUNCHES)
    for dev in ("meta", "cpu"):
        args = make(dev)
        with Count() as c:
            call(*args)
        counts[dev] = c
        flops, n_bytes, _ = kernel_cost(name, **shape)
        assert c.by_kernel[name] == {"calls": 1, "flops": flops,
                                     "bytes": n_bytes}, dev
    assert kernels.LAUNCHES == before
    assert counts["meta"].flops == counts["cpu"].flops
    assert counts["meta"].bytes == counts["cpu"].bytes
    assert counts["meta"].by_kernel == counts["cpu"].by_kernel


def test_meta_route_outputs_have_the_kernels_shapes():
    q = torch.empty((2, 5, 4, 16), device="meta", dtype=torch.bfloat16)
    kv = torch.empty((2, 5, 2, 16), device="meta", dtype=torch.bfloat16)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda,
    )
    o, lse = flash_attention_cuda(q, kv, kv, with_lse=True)
    assert o.is_meta and o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (2, 4, 5) and lse.dtype == torch.float32
    grads = flash_attention_bwd_cuda(q, kv, kv, o, o, lse)
    assert [g.shape for g in grads] == [q.shape, kv.shape, kv.shape]
    with pytest.raises(ValueError):
        flash_attention_cuda(q, kv[:, :, :1].expand(2, 5, 3, 16), kv)
    out = prefix_avg({"w": torch.empty((3, 7), device="meta")},
                     torch.empty((4, 3), device="meta", dtype=torch.int64),
                     torch.empty(3, device="meta"))
    assert out["w"].is_meta and out["w"].shape == (12, 7)


# ------------------------------------------------------- the step counts --

STEP_CASES = [(arch, kind) for arch in ("tinyllama_1_1b", "qwen3_moe_30b_a3b",
                                        "mamba2_370m", "hymba_1_5b")
              for kind in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,kind", STEP_CASES)
def test_meta_count_equals_cpu_count(arch, kind):
    """A reduced step (2 layers, S = 256, the dense attention branch)
    counted on meta equals the same step run on the CPU under the same
    Count: FLOPs, bytes, arguments and live-byte peak, exactly."""
    cfg = get_config(arch).reduced(n_layers=2)
    shape = shapes.InputShape("reduced", 256, 2, kind)
    meta = dryrun.count_step(cfg, shape, "meta")
    cpu = dryrun.count_step(cfg, shape, "cpu")
    for key in ("flops", "bytes_accessed", "compute_s", "argument_bytes",
                "peak_bytes", "kernels"):
        assert meta[key] == cpu[key], key
    assert meta["flops"] > 0 and meta["peak_bytes"] > meta["argument_bytes"]


def test_assembled_roofline_equals_direct_count():
    cfg = get_config("tinyllama_1_1b").reduced(n_layers=3)
    shape = shapes.InputShape("reduced", 256, 2, "train")
    asm = roofline.assembled_roofline(cfg, shape)
    full = dryrun.count_step(cfg, shape)
    assert asm["per_device_flops"] == full["flops"]
    assert asm["per_device_bytes"] == full["bytes_accessed"]
    assert math.isclose(asm["per_device_compute_s"], full["compute_s"],
                        rel_tol=1e-12)
    assert asm["per_device_flops"] == asm["stem"]["flops"] + \
        3 * asm["per_layer"]["flops"]


def _ref_record_keys() -> set:
    """The keys of the reference's `ok` record, read from its source."""
    tree = ast.parse((REF_LAUNCH / "dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(v, ast.Constant) and v.value == "ok"
                for v in node.values):
            keys = {k.value for k in node.keys}
    for node in ast.walk(tree):     # rec["assembled"] = ..., rec["roofline"]
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "rec"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_run_one_writes_the_reference_record(tmp_path):
    """Full-size TinyLlama x train_4k on meta: the reference's keys (a
    count time in place of lower / compile seconds, no collective parse
    on one device), `fits` false (B = 256 x 4096 needs far more than 80
    GB), the flash kernels counted by formula 44 and 22 times, and the
    roofline report's keys; a skipped shape as the reference skips it."""
    rec = dryrun.run_one("tinyllama_1_1b", "train_4k", out_dir=tmp_path)
    want = _ref_record_keys() - {"lower_s", "compile_s",
                                 "collective_bytes_toplevel"}
    assert set(rec) == want | {"count_s", "fits", "kernels"}
    assert rec["n_devices"] == 1 and rec["fits"] is False
    assert rec["memory"]["peak_bytes"] > 80e9
    assert {k: v["calls"] for k, v in rec["kernels"].items()} == \
        {"flash_attention": 44, "flash_attention_bwd": 22}
    ref_report = jax_roofline.roofline_report(
        jax_get_config("tinyllama_1_1b"), jax_shapes.SHAPES["train_4k"],
        {"assembled": {"per_device_flops": 1.0, "per_device_bytes": 1.0,
                       "per_device_collective_bytes": 0.0}}, n_devices=1)
    assert set(rec["roofline"]) == set(ref_report) | {"collectives"}
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["roofline"]["step_time_lower_bound_s"] == max(
        rec["roofline"]["compute_s"], rec["roofline"]["memory_s"])
    saved = sorted(p.name for p in tmp_path.iterdir())
    assert saved == ["tinyllama-1.1b__train_4k__h100.json"]
    skip = dryrun.run_one("chatglm3_6b", "long_500k", out_dir=tmp_path)
    assert skip["status"] == "skipped" and skip["reason"] == \
        jax_shapes.shape_applicable(jax_get_config("chatglm3_6b"),
                                    jax_shapes.SHAPES["long_500k"])[1]


def _ref_variants() -> dict:
    tree = ast.parse((REF_LAUNCH / "hillclimb.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("no VARIANTS in the reference's hillclimb.py")


def test_hillclimb_variants_and_record(tmp_path):
    assert hillclimb.VARIANTS == _ref_variants()
    rec = hillclimb.run_variant("tinyllama_train/v2_dp", tmp_path)
    assert rec["overrides"] == {"parallelism": "dp"}
    assert rec["sharding_overrides"] == ["parallelism"]
    assert rec["status"] == "ok" and "roofline" in rec
    assert [p.name for p in tmp_path.iterdir()] == \
        ["tinyllama_train__v2_dp.json"]


def test_rates_have_one_home():
    """The H100 rates are written in launch/roofline.py alone, in the
    port and in chip_smoke.py."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    found = [str(p.relative_to(ROOT)) for p in files
             if re.search(r"989e12|3\.35e12|495e12|67e12", p.read_text())]
    assert found == ["src/repro_torch/launch/roofline.py"]


def test_resolve_device_accepts_meta_and_builds_on_it():
    from repro_torch.device import resolve_device
    assert resolve_device("meta").type == "meta"
    cfg = dataclasses.replace(get_config("whisper_medium").reduced(),
                              dtype="bfloat16")
    fn, args = dryrun.build_step(cfg, shapes.InputShape("r", 64, 2,
                                                        "train"))
    assert all(t.is_meta for t in tree_leaves(args[0]))
    assert args[2]["frames"].dtype == torch.bfloat16
    assert args[2]["tokens"].dtype == torch.int32
