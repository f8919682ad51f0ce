"""Client data partitioning: Dirichlet(alpha) label skew x power-law sizes.

The port's own numpy copy of `repro/federated/partition.py`: the same rng
draws in the same order, so a seed gives equal partitions.

Paper Section IV "Data Heterogeneity":
  * label distribution of client k ~ Dirichlet(alpha) over the 10 classes;
    alpha in {1e-4, 0.1, 100} (1e-4 ~ one class per client, 100 ~ uniform);
  * client sizes n_k = q_k * n_train with q_k ~ P(x) = 3x^2 on (0,1),
    normalised to sum 1 (as in Power-of-Choice [7]).
"""
from __future__ import annotations

import numpy as np


def power_law_fractions(n_clients: int, rng: np.random.Generator,
                        min_samples_frac: float = 1e-4) -> np.ndarray:
    """q_k sampled from density 3x^2 (inverse-CDF: U^(1/3)), normalised."""
    q = rng.random(n_clients) ** (1.0 / 3.0)
    q = np.maximum(q, min_samples_frac)
    return q / q.sum()


def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    rng: np.random.Generator,
    fractions: np.ndarray | None = None,
    min_per_client: int = 2,
) -> list[np.ndarray]:
    """Return per-client index arrays into `labels`.

    Each client draws a label distribution p_k ~ Dirichlet(alpha * 1_C) and a
    size n_k from the power-law fractions, then fills its quota by sampling
    classes from p_k out of the remaining pool (falling back to whatever
    classes still have samples).
    """
    n = labels.shape[0]
    classes = np.unique(labels)
    if fractions is None:
        fractions = power_law_fractions(n_clients, rng)
    sizes = np.maximum((fractions * n).astype(int), min_per_client)

    # Per-class pools as permuted arrays consumed front-to-cursor: a
    # client's grant of g samples from class c is the next g entries of a
    # uniformly random order — the same distribution as g sequential
    # `pool.pop()` draws, at O(1) per sample instead of O(C) python work.
    pools = [rng.permutation(np.where(labels == c)[0]) for c in classes]
    cursors = np.zeros(len(classes), np.int64)
    remaining = np.asarray([p.size for p in pools], np.int64)
    # Dirichlet with very small alpha underflows to nan in np; clip.
    a = max(alpha, 1e-6)
    out: list[np.ndarray] = []
    for k in range(n_clients):
        p = rng.dirichlet(np.full(classes.shape[0], a))
        take_parts: list[np.ndarray] = []
        need = int(sizes[k])
        # whole-quota batched class draws: each pass either fills the
        # remaining quota or exhausts >= 1 class, so <= C+1 passes/client
        while need > 0:
            avail = np.where(remaining > 0)[0]
            if avail.size == 0:
                break
            pa = p[avail]
            s = pa.sum()
            pa = (pa / s if s > 1e-12
                  else np.full(avail.size, 1.0 / avail.size))
            cnt = np.bincount(rng.choice(avail.size, size=need, p=pa),
                              minlength=avail.size)
            grant = np.minimum(cnt, remaining[avail])
            for ci, g in zip(avail, grant):
                if g:
                    take_parts.append(pools[ci][cursors[ci]:cursors[ci] + g])
            cursors[avail] += grant
            remaining[avail] -= grant
            need -= int(grant.sum())
        take = (np.concatenate(take_parts) if take_parts
                else np.empty(0, np.int64))
        if take.size < min_per_client:  # top up from global remainder
            for ci in range(len(classes)):
                g = min(min_per_client - take.size, int(remaining[ci]))
                if g > 0:
                    take = np.concatenate(
                        [take, pools[ci][cursors[ci]:cursors[ci] + g]])
                    cursors[ci] += g
                    remaining[ci] -= g
        out.append(np.asarray(take, np.int64))
    return out


# --------------------------------------------------------------------------
# padded-stack blocks: the (N, cap, ...) layout the engines consume, built
# one client-axis slice at a time (the dense stack is lo=0, hi=N)
# --------------------------------------------------------------------------

def client_cap(parts: list[np.ndarray]) -> int:
    """Padded per-client capacity: the largest client's sample count."""
    return max(int(p.size) for p in parts)


def padded_x_block(x: np.ndarray, parts: list[np.ndarray], cap: int,
                   lo: int, hi: int) -> np.ndarray:
    """(hi-lo, cap, ...) float32 rows [lo, hi) of the padded data stack;
    rows past len(parts) are pad clients (all zeros, n_valid 0)."""
    out = np.zeros((hi - lo, cap) + x.shape[1:], np.float32)
    for i in range(lo, min(hi, len(parts))):
        p = parts[i]
        out[i - lo, : p.size] = x[p]
    return out


def padded_y_block(y: np.ndarray, parts: list[np.ndarray], cap: int,
                   lo: int, hi: int) -> np.ndarray:
    """(hi-lo, cap) int32 label rows [lo, hi) of the padded stack."""
    out = np.zeros((hi - lo, cap), np.int32)
    for i in range(lo, min(hi, len(parts))):
        p = parts[i]
        out[i - lo, : p.size] = y[p]
    return out


def valid_counts(parts: list[np.ndarray], lo: int, hi: int) -> np.ndarray:
    """(hi-lo,) int32 per-client sample counts for rows [lo, hi)."""
    out = np.zeros((hi - lo,), np.int32)
    for i in range(lo, min(hi, len(parts))):
        out[i - lo] = parts[i].size
    return out


def partition_summary(parts: list[np.ndarray], labels: np.ndarray) -> dict:
    sizes = np.array([p.size for p in parts])
    ent = []
    for p in parts:
        if p.size == 0:
            ent.append(0.0)
            continue
        _, cnt = np.unique(labels[p], return_counts=True)
        q = cnt / cnt.sum()
        ent.append(float(-(q * np.log(q + 1e-12)).sum()))
    return {
        "sizes_min": int(sizes.min()), "sizes_max": int(sizes.max()),
        "sizes_mean": float(sizes.mean()),
        "label_entropy_mean": float(np.mean(ent)),  # ~0 => one class/client
    }
