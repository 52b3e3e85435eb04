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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Collection, Dict, List, Optional, Sequence, Tuple

import torch


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
        g = grads[k].float() * scale
        m, v, master = state.m[k], state.v[k], state.master[k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master.sub_(lr * (upd + cfg.weight_decay * _decay_mask(k) * master))
        params[k].copy_(master)
    state.step = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
