"""Mixed-precision AdamW, as the JAX package's `optim/adamw.py`.

fp32 master copies and (m, v) moments of every parameter; the global
gradient norm is clipped in fp32; weight decay skips norms, biases and
the SSM's small vectors (`_decay_mask`).  On a data mesh the master,
m and v of a ZDP leaf live in the leaf's placement, the rank's shard
(`state_shardings`: the ZeRO layout), since `init_state` copies the
rank's parameters; `global_grad_norm` sums the squares of the ZDP
shards over the ranks and counts each replicated leaf once.

Unlike the JAX package, `apply_update` works in place: the master, m
and v tensors of `state` are updated and the new bf16 values are copied
into `params`, so a step holds no second copy of the optimizer state.
It walks each leaf in flat slices of at most `UPDATE_SLICE` elements:
the update is elementwise, so the values are the same bit for bit,
and its fp32 temporaries stay at a few slices whatever the leaf (a
stacked leaf such as mamba2-2.7b's w_zx, 1.68 B elements, would
otherwise take several 6.7 GB temporaries beside 42 GiB of state).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Collection, Dict, List, Optional, Sequence, Tuple

import torch

UPDATE_SLICE = 1 << 26      # elements of a leaf updated together


@dataclass
class AdamWState:
    step: int
    master: Dict[str, torch.Tensor]   # fp32 copies
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_state(params: Dict[str, torch.Tensor]) -> AdamWState:
    master = {k: p.detach().to(torch.float32, copy=True)
              for k, p in params.items()}
    return AdamWState(0, master,
                      {k: torch.zeros_like(p) for k, p in master.items()},
                      {k: torch.zeros_like(p) for k, p in master.items()})


def _decay_mask(path: str) -> float:
    """No weight decay on norms / biases / 1-D tensors by convention."""
    skip = ("norm", "bias", "A_log", "/D", "dt_bias", "mask")
    return 0.0 if any(s in path for s in skip) else 1.0


def state_shardings(param_placements: Dict[str, Optional[int]],
                    replicated=None) -> AdamWState:
    """Optimizer-state placement tree mirroring the params: each state
    of a leaf in the leaf's placement, the step `replicated`."""
    return AdamWState(step=replicated, master=dict(param_placements),
                      m=dict(param_placements), v=dict(param_placements))


@torch.no_grad()
def global_grad_norm(grads: Dict[str, torch.Tensor], mesh=None,
                     sharded: Collection[str] = (),
                     extra: Sequence[torch.Tensor] = ()
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(the fp32 norm of every gradient, `extra` summed over the ranks).

    The leaves' sums of squares are added in sorted key order, the JAX
    package's (its gradient dict iterates so).  On `mesh` the leaves in
    `sharded` hold the rank's shard, so their sums are added over the
    ranks, and a replicated leaf counts once (rank 0's): one all-reduce
    of the per-leaf sums, which carries the fp32 scalars of `extra`
    (e.g. the loss over W) too.  At world 1 the norm is the unsharded
    one, bit for bit."""
    keys = sorted(grads)
    parts = [torch.sum(grads[k].float() ** 2) for k in keys]
    if mesh is None:
        return torch.sqrt(sum(parts)), list(extra)
    if mesh.rank:
        parts = [p if k in sharded else torch.zeros_like(p)
                 for k, p in zip(keys, parts)]
    v = mesh.all_reduce_sum(torch.stack(parts + [e.float() for e in extra]),
                            "grad_norm")
    vals = v.unbind()
    return torch.sqrt(sum(vals[:len(keys)])), list(vals[len(keys):])


@torch.no_grad()
def apply_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 lr_scale: float, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, torch.Tensor], AdamWState, Dict]:
    """One AdamW step in place (see the module note); returns (params,
    state, {"grad_norm", "lr"}) with params and state the updated
    inputs.  `gnorm` is the global gradient norm when the caller has it
    (a sharded step: `global_grad_norm` on its mesh)."""
    step = state.step + 1
    keys = sorted(params)
    if gnorm is None:
        gnorm, _ = global_grad_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1.0 - cfg.b1 ** step
    bc2 = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale
    for k in keys:
        leaf = (params[k], grads[k], state.m[k], state.v[k],
                state.master[k])
        wd = cfg.weight_decay * _decay_mask(k)
        if all(t.is_contiguous() for t in leaf):
            flat = [t.view(-1) for t in leaf]
            for i in range(0, flat[0].numel(), UPDATE_SLICE):
                _update(cfg, *(t[i:i + UPDATE_SLICE] for t in flat), scale,
                        bc1, bc2, lr, wd)
        else:
            _update(cfg, *leaf, scale, bc1, bc2, lr, wd)
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update(cfg: AdamWConfig, p, grad, m, v, master, scale, bc1, bc2, lr,
            wd) -> None:
    """AdamW on one leaf or slice of one, in place."""
    g = grad.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
    master.sub_(lr * (upd + wd * master))
    p.copy_(master)
