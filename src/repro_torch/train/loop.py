"""Training loop: the JAX package's `train/loop.py`, on one device or
sharded over a data mesh.

`make_train_step(built, ...)` returns (step_fn, init_fn), as there;
PyTorch runs eagerly, so step_fn is a plain function: value and grads
(microbatched: gradients accumulated in fp32 and averaged), the
warmup-cosine scale, and the in-place AdamW update.  Every product,
attention and SSD chunk scan of the forward and backward goes through
the port's kernels (`kernels.ops`): on a card the CUDA kernels, on the
CPU their plain versions.

On a data mesh (`built.mesh`, the JAX package's mesh branch) each rank
takes its rows of the global batch and holds the plan's ZDP leaves and
their AdamW states as shards.  A ZDP leaf's gradient is reduce-scattered
in the backward (`sharding.collectives`); the DP leaves' gradients are
all-reduced (mean) once after it, and one more all-reduce gives the
global gradient norm and the global loss.  Loss and gradients are the
global batch's mean, whatever the split; microbatching cuts a rank's
rows.  Checkpoints gather the shards and are written by rank 0.

`restore_or_init` and `train`'s checkpoint arguments are the JAX
package's: crash-safe checkpoints in its on-disk format
(`checkpoint.io`), resume from the latest valid step, retention, and
the fault schedule's device losses and checkpoint-write crashes.

Not here yet: the gradient bucketing of `OverlapConfig`
(`_bucket_grads`, an XLA scheduling device that is identity on values;
ROADMAP section 1 item 6).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.data.synthetic import Dataset
from repro_torch.models.registry import Built, input_shardings, resolve_device
from repro_torch.optim import (AdamWConfig, AdamWState, apply_update,
                               init_state, warmup_cosine)
from repro_torch.optim.adamw import global_grad_norm, state_shardings


def loss_and_grads(model, params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], microbatch: int = 0):
    """(loss, metrics, grads) of `model.loss_fn`; with `microbatch` n > 1
    the batch is cut into n row blocks whose gradients are summed in
    fp32 and averaged, as the JAX package's scan does."""
    keys = list(params)
    leaves = [params[k].requires_grad_(True) for k in keys]

    def one(b):
        loss, metrics = model.loss_fn(params, b)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(keys, grads)))

    if microbatch <= 1:
        return one(batch)
    n = microbatch
    per = next(iter(batch.values())).shape[0] // n
    acc_loss = torch.zeros((), device=leaves[0].device)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    metrics = {}
    for i in range(n):
        loss, metrics, grads = one({k: v[i * per:(i + 1) * per]
                                    for k, v in batch.items()})
        acc_loss = acc_loss + loss
        for k, g in grads.items():
            acc[k] += g
        del grads
    return acc_loss / n, metrics, {k: g / n for k, g in acc.items()}


def make_train_step(built: Built, opt_cfg: Optional[AdamWConfig] = None,
                    total_steps: int = 10_000, warmup: int = 100
                    ) -> Tuple[Callable, Callable]:
    """(step_fn, init_fn): step_fn(params, opt_state, batch) -> (params,
    opt_state, metrics), updating params and opt_state in place;
    init_fn(seed, device) -> (params, opt_state).  On `built.mesh`,
    params, opt_state and batch are the rank's (`Built.init`, its rows
    of the global batch), and metrics' loss and grad_norm are global
    (ce, aux and tokens are the rank's)."""
    opt_cfg = opt_cfg or AdamWConfig()
    model = built.model
    micro = built.run.microbatch
    mesh = built.mesh
    sharded = frozenset(built.pset.sharded())

    def step(params, opt_state: AdamWState, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch, micro)
        lr_scale = warmup_cosine(opt_state.step + 1, warmup, total_steps)
        gnorm = None
        if mesh is not None:
            dp = {k: g for k, g in grads.items() if k not in sharded}
            if dp:
                grads.update(mesh.all_reduce_mean(dp, "dp"))
            gnorm, (loss,) = global_grad_norm(grads, mesh, sharded,
                                              [loss / mesh.world])
        params, opt_state, opt_metrics = apply_update(
            opt_cfg, params, grads, opt_state, lr_scale, gnorm)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    def init(seed: int = 0, device=None):
        params = built.init(seed, device)
        return params, init_state(params)

    return step, init


@dataclass
class TrainResult:
    steps: int
    losses: list
    tokens_per_s: float
    final_metrics: Dict[str, float] = field(default_factory=dict)
    step_ms: list = field(default_factory=list)   # host clock, synced
    grad_norms: list = field(default_factory=list)
    start_step: int = 0
    params: Optional[Dict[str, torch.Tensor]] = None  # the trained ones


def restore_or_init(built: Built, ckpt_dir: Optional[str], *,
                    seed: int = 0, opt_cfg: Optional[AdamWConfig] = None,
                    warmup: int = 100, total_steps: int = 10_000,
                    device=None,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    print_fn=print):
    """(step_fn, params, opt_state, start_step): resume from the latest
    *valid* checkpoint under `ckpt_dir` when one exists, else a fresh
    init (`built.init(seed)` on `device`, or a copy of the given
    `params` with a new optimizer state; on a mesh the rank's shards of
    them).  Checkpoint validation (CRC + sizes + shapes) happens inside
    `checkpoint.io.restore`; a corrupt latest step raises
    `CheckpointCorruptError` rather than restoring garbage."""
    dev = resolve_device(device)
    step_fn, init_fn = make_train_step(built, opt_cfg, warmup=warmup,
                                       total_steps=total_steps)
    if params is None:
        params, opt_state = init_fn(seed, dev)
    else:
        params = {k: v.detach().to(dev).clone() for k, v in params.items()}
        if built.mesh is not None:
            params = built.pset.local(params)
        opt_state = init_state(params)
    start_step = 0
    if ckpt_dir and ckpt_io.latest_step(ckpt_dir) is not None:
        (params, opt_state), start_step = ckpt_io.restore(
            ckpt_dir, (params, opt_state), device=dev,
            **_ckpt_placement(built))
        print_fn(f"restored checkpoint at step {start_step}")
    return step_fn, params, opt_state, start_step


def _ckpt_placement(built: Built) -> Dict:
    """`checkpoint.io`'s placement arguments for (params, opt_state) on
    the built model's mesh (none unsharded)."""
    if built.mesh is None:
        return {}
    pp = built.pset.placements
    return dict(placements=(pp, state_shardings(pp)), mesh=built.mesh)


def train(built: Built, n_steps: int, *, seed: int = 0,
          opt_cfg: Optional[AdamWConfig] = None,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          keep_last: int = 0, resume: bool = False, log_every: int = 10,
          warmup: int = 100, total_steps: int = 10_000, faults=None,
          device=None, params: Optional[Dict[str, torch.Tensor]] = None,
          print_fn=print) -> TrainResult:
    """Training loop on the synthetic pipeline, as the JAX package's
    `train`.  `device` defaults to the card (raising without one);
    `params` starts from given full weights (the parity tests carry the
    JAX package's across) instead of `built.init(seed)`.  Each step's
    host time is taken after the loss is read back, so the device has
    finished it.  On `built.mesh` every rank runs it: each takes its
    rows of `Dataset.global_batch(s)`, and every rank reports the global
    loss and gradient norm; `TrainResult.params` are the rank's.

    `resume=True` makes `n_steps` the TOTAL step target: a restored run
    skips its already-completed steps (restoring at step >= `n_steps`
    trains nothing).  The default (False) trains `n_steps` more from
    wherever the restore landed.  With `ckpt_dir` a checkpoint is
    written every `ckpt_every` steps and at the end; `keep_last > 0`
    keeps the newest N.  `faults` (a `resilience.faults.FaultSchedule`)
    injects device losses (`DeviceLost` at the scheduled step) and
    checkpoint-write crashes (`CheckpointCrashError` mid-save)."""
    step_fn, params, opt_state, start_step = restore_or_init(
        built, ckpt_dir, seed=seed, opt_cfg=opt_cfg, warmup=warmup,
        total_steps=total_steps, device=device, params=params,
        print_fn=print_fn)
    dev = next(iter(params.values())).device
    ds = Dataset(built.run.model, built.run.shape, seed=seed)
    target = n_steps if resume else start_step + n_steps
    if resume and start_step >= target:
        print_fn(f"nothing to do: restored step {start_step} >= "
                 f"target {target}")
        return TrainResult(0, [], 0.0, {}, start_step=start_step)

    def save(step: int) -> None:
        crash = (faults.checkpoint_crash_at(step)
                 if faults is not None else None)
        ckpt_io.save(ckpt_dir, step, (params, opt_state),
                     keep_last=keep_last,
                     crash_after_leaves=(crash.after_leaves
                                         if crash else None),
                     **_ckpt_placement(built))

    losses, step_ms, grad_norms = [], [], []
    tokens = 0
    metrics: Dict = {}
    t0 = time.perf_counter()
    for s in range(start_step, target):
        if faults is not None:
            ev = faults.device_loss_at(s)
            if ev is not None:
                from repro_torch.resilience.faults import DeviceLost
                raise DeviceLost(ev, s)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in ds.global_batch(s).items()}
        tokens += int(batch["labels"].numel())
        if built.mesh is not None:
            place = input_shardings(built.run, built.mesh, batch)
            batch = {k: place[k].local(v) for k, v in batch.items()}
        batch = {k: v.to(dev) for k, v in batch.items()}
        ts = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        step_ms.append(1e3 * (time.perf_counter() - ts))
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if log_every and (s % log_every == 0 or s == target - 1):
            print_fn(f"step {s:5d} loss {loss:.4f} "
                     f"gnorm {float(metrics['grad_norm']):.3f}")
        if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
            save(s + 1)
    dt = time.perf_counter() - t0
    if ckpt_dir:
        save(target)
    return TrainResult(target - start_step, losses, tokens / dt,
                       {k: float(v) for k, v in metrics.items()}, step_ms,
                       grad_norms, start_step, params)
