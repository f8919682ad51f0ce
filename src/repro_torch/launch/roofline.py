"""Roofline of a step on NVIDIA H100s, one or a mesh of them, and the
card's rates (counterpart of `repro/launch/roofline.py`).

The rates of the card, defined here and nowhere else in the port
(NVIDIA H100 80GB HBM3 SXM, at its 700.00 W power limit; dense tensor-core
rates, no sparsity):

    float32 on the CUDA cores   67 TFLOP/s (the port turns TF32 off)
    TF32 tensor cores          495 TFLOP/s
    bf16 tensor cores          989 TFLOP/s
    HBM3                      3.35 TB/s, 80 GB

and of the links between cards (spec figures, not measurements; the
reference's ICI_BW is a TPU's and is not used):

    NVLink 4 within an 8-card node   450 GB/s each way a card (NVIDIA H100
                                     SXM datasheet: 900 GB/s bidirectional)
    the network beyond the node       50 GB/s a card (NVIDIA DGX H100
                                     datasheet: one 400 Gb/s ConnectX-7
                                     NDR InfiniBand port a card)

Three terms per (arch x shape x mesh), per device:

    compute    = sum over ops of FLOPs / the peak of the op's dtype
    memory     = bytes accessed / 3.35e12
    collective = sum over the axes crossed of the collectives' weighted
                 result bytes / that link's rate

The counts come from `launch.compat.Count`, which runs the step eagerly on
`meta` tensors (nothing is computed or allocated): each aten op's FLOPs by
`torch.utils.flop_counter`'s formulas, its bytes as the nbytes of its tensor
inputs and outputs, and each hand-written kernel by its own formula,
`kernel_cost`, whichever of its routes ran.  A single peak would be wrong
on a card whose float32 and bf16 rates are 15x apart, so `compute_s` sums
each op's FLOPs over its own dtype's peak.  On a mesh the step runs as one
rank's part of it (rank 0's, on the virtual production mesh), and every
collective it issues is counted (`launch/collectives.py`: the
counterpart of XLA's HLO-text parse, `collective_bytes_from_text`, in its
layout, all-reduce weighted twice) with the axes it crosses: a group of
ranks inside one 8-card node goes at the NVLink rate, one that spans
nodes at the network's (ranks are laid out row-major, the last axis
fastest).  One device moves no collective bytes: `collective_s` is 0.

Eager torch counts every layer, but the 1- and 2-layer differencing of the
reference (`assembled_roofline`) is kept, so that `per_layer` and `stem`
keep their meaning: layer = cost(L=2) - cost(L=1), stem = cost(L=1) -
layer, total = stem + L * layer.
"""
from __future__ import annotations

import dataclasses

import numpy as np

F32_PEAK_FLOPS = 67e12       # float32 on the CUDA cores (TF32 off)
TF32_PEAK_FLOPS = 495e12     # TF32 tensor cores, dense
BF16_PEAK_FLOPS = 989e12     # bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12    # HBM3
HBM_BYTES = 80e9             # the card's 80 GB
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, each way a card, within a node
NETWORK_BYTES_PER_S = 50e9   # one 400 Gb/s NDR port a card, across nodes
CARDS_PER_NODE = 8


def link_bytes_per_s(mesh, axes: str) -> float:
    """The rate of a collective over `axes` ("data+model": the names joined
    by "+") of `mesh`: NVLink when rank 0's group of those axes lies in
    one node of CARDS_PER_NODE cards, the network otherwise."""
    names = axes.split("+") if axes else []
    span, stride = 0, 1
    for a in reversed(mesh.axis_names):
        if a in names:
            span += (mesh.shape[a] - 1) * stride
        stride *= mesh.shape[a]
    return NVLINK_BYTES_PER_S if span < CARDS_PER_NODE else \
        NETWORK_BYTES_PER_S


def collective_s(mesh, by_axes: dict) -> float:
    """Seconds of a count's collectives: weighted bytes over each link."""
    if mesh is None:
        return 0.0
    return sum(n / link_bytes_per_s(mesh, axes)
               for axes, n in by_axes.items())


def bound_s(flops: float, n_bytes: float,
            peak: float = F32_PEAK_FLOPS) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time the card takes
    for work of `flops` operations at `peak` and `n_bytes` bytes moved,
    the larger of the two terms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------ the kernels' costs --

def band_pairs(s_len: int, t_len: int, window: int = 0,
               causal: bool = True) -> int:
    """Unmasked (query, key) pairs of one head with query positions
    0 .. S-1 and key positions 0 .. T-1, under the causal and window masks
    the kernels apply (key <= query; key > query - window)."""
    q = np.arange(s_len, dtype=np.int64)
    hi = np.minimum(q, t_len - 1) if causal else np.full_like(q, t_len - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _flash_work(b, s, t, hq, hd, causal, window, itemsize):
    """(forward FLOPs, peak) of the forward: 4 hd FLOPs a visible pair
    (Q K^T and P V), on the bf16 tensor cores, or as three TF32 products
    each (the float32 route's split products)."""
    flops = 4 * hd * band_pairs(s, t, window, causal) * b * hq
    if itemsize == 2:
        return flops, BF16_PEAK_FLOPS
    return 3 * flops, TF32_PEAK_FLOPS


def kernel_cost(name: str, **shapes) -> tuple[float, float, float]:
    """(FLOPs, bytes, peak FLOP/s) of one call of a hand-written kernel:
    each input read once and each output written once, and the operations
    this call's shapes need.  `itemsize` is the element size of the
    kernel's data (4 float32, 2 bf16).

    prefix_avg(r, m, d, itemsize): R walks of M clients over D columns
        (summed over the tree's leaves): the (M, D) stacks, the (R, M) int64
        walks and the (M,) f32 sizes in, the (R*M, D) prefix models out;
        3 FLOPs an output (scale, add, divide).
    ce_loss(models, rows, v, itemsize): (models*rows, V) logits and (rows,)
        int64 labels in, one f32 loss a row out; 4 FLOPs a logit.
    cohort_gather(m, row_bytes, device_ids): M rows of `row_bytes` (summed
        over the tables) read and written, the M int64 ids read once, and
        with device ids the int64 error word written.
    cohort_gather_shard(m, row_bytes, hits): one rank's block: the `hits`
        rows of its block that the cohort holds read (default M, as on
        one rank), M rows of `row_bytes` written (zeros where the block
        misses), the M int64 ids read and the error word written.  The
        all_reduce after it is not the kernel's.
    delta_codec(m, d): the (M, D) f32 stack and the (D,) server weights in,
        the (M, D) result out; ~8 FLOPs an entry.
    weighted_avg(r, m, d, itemsize): the (M, D) stacks and (R, M) weights
        in, the (R, D) averages out; 2 FLOPs a weight a column.
    flash_attention(b, s, t, hq, kh, hd, itemsize, causal, window, lse):
        q and o (B, S, Hq, hd), k and v (B, T, Kh, hd), and with `lse` the
        (B, Hq, S) f32 log-sum-exp written; 4 hd FLOPs a visible pair at
        989 TFLOP/s for bf16, three split-TF32 products of that at 495 for
        float32.
    flash_attention_bwd(same): q, o, dO, dq and k, v, dk, dv, the lse read;
        2.5 x the forward's FLOPs at the forward's peak.
    flash_attention_wide, flash_attention_wide_bwd (same): the route for
        head dims above 128; the same work and so the same bound as the
        tensor-core routes' (it runs on the CUDA cores, slower than that).
    """
    if name.startswith("flash_attention_wide"):
        name = name.replace("_wide", "")
    if name == "prefix_avg":
        r, m, d = shapes["r"], shapes["m"], shapes["d"]
        size = shapes.get("itemsize", 4)
        return (3 * r * m * d, m * d * size * (1 + r) + r * m * 8 + m * 4,
                F32_PEAK_FLOPS)
    if name == "ce_loss":
        n, rows, v = shapes["models"], shapes["rows"], shapes["v"]
        size = shapes.get("itemsize", 4)
        return (4 * n * rows * v, n * rows * v * size + rows * 8
                + n * rows * 4, F32_PEAK_FLOPS)
    if name == "cohort_gather":
        m = shapes["m"]
        word = 8 if shapes.get("device_ids", False) else 0
        return 0, 2 * m * shapes["row_bytes"] + m * 8 + word, F32_PEAK_FLOPS
    if name == "cohort_gather_shard":
        m, row = shapes["m"], shapes["row_bytes"]
        return (0, (shapes.get("hits", m) + m) * row + m * 8 + 8,
                F32_PEAK_FLOPS)
    if name == "delta_codec":
        m, d = shapes["m"], shapes["d"]
        return 8 * m * d, (2 * m + 1) * d * 4, F32_PEAK_FLOPS
    if name == "weighted_avg":
        r, m, d = shapes["r"], shapes["m"], shapes["d"]
        size = shapes.get("itemsize", 4)
        return 2 * r * m * d, (m * d + r * m + r * d) * size, F32_PEAK_FLOPS
    if name in ("flash_attention", "flash_attention_bwd"):
        b, s, t = shapes["b"], shapes["s"], shapes["t"]
        hq, kh, hd = shapes["hq"], shapes["kh"], shapes["hd"]
        size = shapes["itemsize"]
        flops, peak = _flash_work(b, s, t, hq, hd, shapes.get("causal", True),
                                  shapes.get("window", 0), size)
        q_side, kv_side, lse = b * s * hq * hd, b * t * kh * hd, b * hq * s * 4
        if name == "flash_attention":
            return (flops, (2 * q_side + 2 * kv_side) * size
                    + (lse if shapes.get("lse", False) else 0), peak)
        return 2.5 * flops, (4 * q_side + 4 * kv_side) * size + lse, peak
    raise ValueError(f"no cost formula for kernel {name!r}")


# --------------------------------------------------------- the step roofline --

def assembled_roofline(cfg, shape, mesh=None) -> dict:
    """FLOPs, bytes, compute seconds and (on a mesh) collective bytes and
    seconds of the step per device, by 1- and 2-layer differencing of its
    meta counts (remat off, as the reference assembles)."""
    from repro_torch.launch.dryrun import count_step  # circular-safe

    def cost_with_layers(n: int) -> dict:
        enc = min(cfg.encoder_layers, n) if cfg.encoder_layers else 0
        c = dataclasses.replace(cfg, n_layers=n, encoder_layers=enc,
                                scan_layers=False, remat=False)
        rec = count_step(c, shape, mesh=mesh)
        coll = rec["collectives"]
        return dict(rec, collective_bytes=float(coll["weighted_total"]),
                    collective_s=collective_s(mesh, coll["by_axes"]))

    c1 = cost_with_layers(1)
    c2 = cost_with_layers(2)
    n_layers = cfg.n_layers

    def assemble(key):
        layer = max(c2[key] - c1[key], 0.0)
        stem = max(c1[key] - layer, 0.0)
        return stem + n_layers * layer, layer, stem

    flops, flops_layer, flops_stem = assemble("flops")
    bytes_, bytes_layer, bytes_stem = assemble("bytes_accessed")
    comp, comp_layer, comp_stem = assemble("compute_s")
    coll, coll_layer, coll_stem = assemble("collective_bytes")
    coll_t, coll_t_layer, coll_t_stem = assemble("collective_s")
    return {
        "per_device_flops": flops,
        "per_device_bytes": bytes_,
        "per_device_collective_bytes": coll,
        "per_device_compute_s": comp,
        "per_device_collective_s": coll_t,
        "per_layer": {"flops": flops_layer, "bytes": bytes_layer,
                      "collective_bytes": coll_layer,
                      "compute_s": comp_layer,
                      "collective_s": coll_t_layer},
        "stem": {"flops": flops_stem, "bytes": bytes_stem,
                 "collective_bytes": coll_stem, "compute_s": comp_stem,
                 "collective_s": coll_t_stem},
        "note": "remat disabled in assembly; training remat adds ~1 fwd of "
                "recompute per layer (the full-depth count, hlo_cost, has "
                "it)",
    }


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active non-embedding params.

    Enc-dec (whisper): the encoder's params only see n_frontend_tokens
    frames, not the decoder's seq_len tokens — counted separately so the
    useful-FLOP ratio stays meaningful.
    """
    from repro_torch.models.lm.config import (
        _attn_params, _ffn_params, active_param_count,
    )
    n = active_param_count(cfg) - cfg.vocab * cfg.d_model  # drop embed gather
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    dec_tokens = shape.global_batch * (
        shape.seq_len if shape.kind != "decode" else 1)

    if not cfg.encoder_layers:
        return mult * n * dec_tokens

    enc_layer = 2 * cfg.d_model + _attn_params(cfg) + _ffn_params(cfg)
    n_enc = cfg.encoder_layers * enc_layer + cfg.d_model
    n_dec = n - n_enc
    enc_tokens = shape.global_batch * cfg.n_frontend_tokens
    # decode reuses the prefilled encoder output: encoder cost amortised away
    enc_mult = 0.0 if shape.kind == "decode" else mult
    return mult * n_dec * dec_tokens + enc_mult * n_enc * enc_tokens


def roofline_report(cfg, shape, rec: dict, *, n_devices: int = 1) -> dict:
    """The reference's report keys from an assembled record: compute,
    memory and collective seconds per device, the dominant term, model
    against counted FLOPs (over the `n_devices`), and the step's lower
    bound."""
    asm = rec["assembled"]
    terms = {"compute_s": asm["per_device_compute_s"],
             "memory_s": asm["per_device_bytes"] / HBM_BYTES_PER_S,
             "collective_s": asm.get("per_device_collective_s", 0.0)}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_global = asm["per_device_flops"] * n_devices
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": mf / hlo_global if hlo_global else 0.0,
        "step_time_lower_bound_s": bound,
        "flops_util_at_bound": terms["compute_s"] / max(bound, 1e-12),
        "collectives": ("none: one device" if n_devices == 1 else
                        f"weighted bytes over NVLink "
                        f"({NVLINK_BYTES_PER_S:.3g} B/s) inside a node of "
                        f"{CARDS_PER_NODE} cards, the network "
                        f"({NETWORK_BYTES_PER_S:.3g} B/s) across nodes; "
                        f"spec figures"),
    }
