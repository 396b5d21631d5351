"""The training step of the JAX package's ``repro/launch/steps.py``
(``build_train_step``), for one device: no mesh, no shardings, no
sequence-parallel ``constrain``.

The step takes the f32 master params, the AdamW state and a batch on the
params' device.  Inside the autograd graph every f32 leaf of two or more
dims is cast to the compute dtype (:func:`cast_for_compute`, as the JAX
step casts at its entry), so the gradients flow back through the casts
to the f32 masters; norm scales and the Mamba2 vectors stay f32.  The
loss and its gradients come from one backward pass; the AdamW update
then runs in place under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import Model
from ..models.param import tree_map
from ..training import optimizer as opt
from ..training.optimizer import leaves


def cast_for_compute(params, dtype: torch.dtype):
    """The tree the forward reads: f32 leaves of 2 or more dims cast to
    ``dtype`` inside the autograd graph, the rest as they are."""
    return tree_map(
        lambda x: x.to(dtype)
        if x.dtype == torch.float32 and x.dim() >= 2 else x, params)


def _unflatten_like(tree, flat):
    """Rebuild ``tree``'s layout from its leaves in :func:`leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def loss_and_grads(model: Model, params, batch, *,
                   remat: Optional[str] = "full",
                   impl: Optional[str] = None):
    """The loss, its metrics and the gradient of every leaf of the f32
    ``params`` (a tree of the same layout), through
    :func:`cast_for_compute` inside the autograd graph.  Every leaf must
    get a gradient: one that the loss does not reach raises."""
    compute_dtype = getattr(torch, model.cfg.dtype)
    masters = leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_(True) for p in masters]
        tree = cast_for_compute(_unflatten_like(params, live), compute_dtype)
        loss, metrics = model.loss_fn(tree, batch, remat=remat, impl=impl)
        grads = torch.autograd.grad(loss, live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, _unflatten_like(params, grads)


def build_train_step(model: Model, *, remat: Optional[str] = "full",
                     adamw: Optional[opt.AdamWConfig] = None,
                     impl: Optional[str] = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss and its gradients
    (:func:`loss_and_grads`), then the AdamW step; ``metrics`` holds the
    loss's {"loss", "ntokens"} and "grad_norm", 0-d tensors on the device
    (read one to wait for the step).  The JAX signature's shape and mesh
    have no part on one device.  ``impl="plain"`` runs the kernels'
    plain versions (comparison only)."""
    adamw = adamw or opt.AdamWConfig()

    def train_step(params, opt_state, batch):
        _, metrics, grads = loss_and_grads(model, params, batch, remat=remat,
                                           impl=impl)
        params, opt_state, gnorm = opt.adamw_update(adamw, grads, opt_state,
                                                    params)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step
