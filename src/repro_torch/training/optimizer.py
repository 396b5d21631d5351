"""AdamW over a param tree, as the JAX package's
``repro/training/optimizer.py`` computes it.

Optimizer moments are declared as ParamSpec trees mirroring the
parameters (f32 zeros) with an int32 step counter, so ``init_params``
materializes the state on any device.  Bias correction and the warm-up
schedule are computed in f32 from the int32 counter, as JAX does
(``b1 ** step`` in f32, not in Python's float64).  The global
gradient-norm clip covers every leaf, and weight decay applies to every
leaf, norms and biases included, as in the reference.

:func:`adamw_update` writes the new params and moments IN PLACE (JAX
returns new arrays into donated buffers), so a step holds no second copy
of the f32 masters or the moments.  A leaf of more than ``PIECE``
elements is updated in contiguous pieces of ``PIECE``, so that the
update's temporaries are a piece's (256 MB in f32), not the leaf's
(mamba2-2.7b's stacked in-projection is 3.4 GB); each element's
arithmetic is the same either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..models.param import ParamSpec, tree_map_specs


#: elements of the pieces a large leaf is updated in
PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def opt_state_specs(param_specs) -> Dict[str, Any]:
    def moment(path, s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.axes, dtype=torch.float32, init="zeros")

    return {
        "mu": tree_map_specs(moment, param_specs),
        "nu": tree_map_specs(moment, param_specs),
        "step": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }


def leaves(tree):
    """The leaves of a nested-dict tree in JAX's order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params):
    """One AdamW step; returns (params, opt_state, grad_norm), the params
    and moments updated in place and ``opt_state["step"]`` replaced by
    the next count."""
    step = opt_state["step"] + 1
    stepf = step.float()
    lr = _schedule(cfg, stepf)

    # global grad-norm clip
    flat_g = leaves(grads)
    sq = sum(torch.sum(torch.square(g.float())) for g in flat_g)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    f32 = dict(dtype=torch.float32, device=stepf.device)
    bc1 = 1 - torch.tensor(b1, **f32) ** stepf
    bc2 = 1 - torch.tensor(b2, **f32) ** stepf
    for leaf in zip(leaves(params), flat_g, leaves(opt_state["mu"]),
                    leaves(opt_state["nu"])):
        # flat views of the updated leaves (view: raises rather than copy)
        p, g, mu, nu = leaf
        flat = (p.view(-1), g.reshape(-1), mu.view(-1), nu.view(-1))
        for p, g, mu, nu in zip(*(t.split(PIECE) for t in flat)):
            gf = g.float() * scale
            mu.mul_(b1).add_((1 - b1) * gf)
            nu.mul_(b2).add_((1 - b2) * torch.square(gf))
            pf = p.float()
            pf = pf - lr * ((mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
                            + cfg.weight_decay * pf)
            p.copy_(pf)
    opt_state["step"] = step
    return params, opt_state, gnorm
