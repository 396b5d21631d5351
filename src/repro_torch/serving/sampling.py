"""Host-side sampling: the reference implementation for the device plane.

A numpy copy of the JAX package's ``repro/serving/sampling.py``.
``sample_ref`` mirrors :func:`repro_torch.serving.device_state.
sample_tokens` operation for operation — same descending stable sort,
same softmax, same nucleus (top-p) truncation, same inverse-CDF draw
from an explicit uniform ``u`` — so the fused step's device sampler can
be held against it.  ``sample`` keeps the convenience API for callers
wanting temperature/top-k on final logits.
"""

from __future__ import annotations

import numpy as np


def nucleus_cdf(logits: np.ndarray, temperature: float,
                top_p: float) -> tuple:
    """(order, kcum, n_keep): descending token order, the kept
    (nucleus-truncated, renormalized) cumulative distribution, and the
    nucleus size.  Shared by ``sample_ref`` and the parity checks'
    boundary filter so they can never diverge."""
    lf = np.asarray(logits, np.float32) / np.float32(temperature)
    order = np.argsort(-lf, kind="stable")
    s = lf[order]
    e = np.exp(s - s.max())
    probs = (e / e.sum()).astype(np.float32)
    cum = np.cumsum(probs, dtype=np.float32)
    keep = (cum - probs) < top_p
    kept = np.where(keep, probs, np.float32(0.0))
    kept = kept / kept.sum()
    kcum = np.cumsum(kept, dtype=np.float32)
    return order, kcum, int(keep.sum())


def sample_ref(logits: np.ndarray, u: float, *, temperature: float,
               top_p: float = 1.0) -> int:
    """Deterministic temperature/top-p draw given uniform ``u`` in [0,1).

    Host reference for the device sampler (identical control flow; float
    associativity is the only divergence, which the checks filter for)."""
    order, kcum, n_keep = nucleus_cdf(logits, temperature, top_p)
    idx = min(int(np.sum(kcum <= np.float32(u))), n_keep - 1)
    return int(order[idx])


def sample(logits: np.ndarray, *, temperature: float = 0.0,
           top_k: int = 0, top_p: float = 1.0,
           rng: np.random.RandomState | None = None) -> int:
    """Convenience sampler over final logits (greedy when temperature=0)."""
    logits = np.asarray(logits, np.float64)
    if temperature <= 0.0:
        return int(np.argmax(logits))
    if top_k:
        idx = np.argpartition(logits, -top_k)[-top_k:]
        mask = np.full_like(logits, -np.inf)
        mask[idx] = logits[idx]
        logits = mask
    rng = rng or np.random.RandomState()
    if top_p < 1.0:
        return sample_ref(logits.astype(np.float32), rng.random_sample(),
                          temperature=temperature, top_p=top_p)
    lt = logits / temperature
    p = np.exp(lt - lt.max())
    p /= p.sum()
    return int(rng.choice(len(p), p=p))
