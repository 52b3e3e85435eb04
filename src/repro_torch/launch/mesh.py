"""The data-parallel mesh over `torch.distributed`: the JAX package's
`launch/mesh.py` for the data axis.

A `DataMesh` is one process group over the ranks of the data axis, with
the collectives a sharded OSDP step issues: `gather` (the all-gather of
a ZDP shard into the full weight), `reduce_scatter` (of the full
weight's gradient onto the shard, averaged), `all_reduce_mean` (the DP
leaves' gradients, one collective per dtype) and `all_reduce_sum`.
The collectives carry no gradient (`sharding.collectives` wires them
into autograd).  Each call is counted by kind and by the leaf it serves
(`calls`, and `nbytes`: the full tensor's bytes per call), so a test or
the chip smoke can hold the executed collectives to the cost model's
ring passes.

NCCL carries CUDA tensors and gloo CPU tensors; a collective on a
tensor the backend does not carry raises.  `make_host_mesh()` is world
1 without a group: every collective is the identity (counted all the
same).  The model axis (TP), a `pipe` axis and meshes of more than one
data axis (`make_hybrid_mesh`, `make_cluster_mesh`) are not ported
(ROADMAP section 1 item 5): `make_mesh_from_config` raises on them.
"""
from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig

_NOT_PORTED = "not ported (ROADMAP section 1 item 5)"


@dataclass
class DataMesh:
    """Ranks of one data axis.  `group` None is world 1 without a process
    group (`make_host_mesh`)."""

    group: Optional[object]
    rank: int
    world: int
    backend: Optional[str]          # "nccl" | "gloo" | None
    axis: str = "data"
    calls: Counter = field(default_factory=Counter)    # (kind, key) -> n
    nbytes: Counter = field(default_factory=Counter)   # (kind, key) -> B

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis, "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.world, "model": 1}

    def reset_counts(self) -> None:
        self.calls.clear()
        self.nbytes.clear()

    def _count(self, kind: str, key: str, t: torch.Tensor) -> None:
        self.calls[kind, key] += 1
        self.nbytes[kind, key] += t.numel() * t.element_size()

    def _check(self, t: torch.Tensor) -> None:
        if self.backend == "gloo" and t.is_cuda:
            raise ValueError("gloo carries CPU tensors only: a CUDA tensor "
                             "needs the nccl backend")
        if self.backend == "nccl" and not t.is_cuda:
            raise ValueError("nccl carries CUDA tensors only: CPU tensors "
                             "need the gloo backend")

    # -- placement ---------------------------------------------------------
    def shard(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's part of `full` along `dim` (a copy, so `full` can
        go); `dim` must divide by the world."""
        n = full.shape[dim]
        if n % self.world:
            raise ValueError(f"dimension {dim} of size {n} does not divide "
                             f"over {self.world} ranks")
        return full.narrow(dim, self.rank * (n // self.world),
                           n // self.world).contiguous()

    # -- collectives -------------------------------------------------------
    @torch.no_grad()
    def gather(self, shard: torch.Tensor, dim: int,
               key: str = "") -> torch.Tensor:
        """All-gather of every rank's `shard` into the full tensor,
        concatenated along `dim`.  The collective concatenates on dim 0,
        so another dim is gathered as (W, *shard) and permuted into
        place."""
        self._check(shard)
        full_shape = list(shard.shape)
        full_shape[dim] *= self.world
        # (W * rows, ...): the collective's layout, read as (W, *shard)
        flat = torch.empty((self.world * shard.shape[0],)
                           + tuple(shard.shape[1:]),
                           dtype=shard.dtype, device=shard.device)
        self._count("all_gather", key, flat)
        if self.group is None:
            flat.copy_(shard)
        else:
            dist.all_gather_into_tensor(flat, shard.contiguous(),
                                        group=self.group)
        out = flat.view((self.world,) + tuple(shard.shape))
        if dim == 0:
            return out.view(full_shape)
        return out.movedim(0, dim).reshape(full_shape)

    @torch.no_grad()
    def reduce_scatter(self, full: torch.Tensor, dim: int,
                       key: str = "") -> torch.Tensor:
        """The mean over ranks of `full`, each rank keeping its part along
        `dim` (the layout `gather` assembles)."""
        self._check(full)
        W = self.world
        parts = full.unflatten(dim, (W, full.shape[dim] // W)).movedim(
            dim, 0).contiguous()
        self._count("reduce_scatter", key, full)
        if self.group is None:
            return parts[0]
        out = torch.empty(parts.shape[1:], dtype=full.dtype,
                          device=full.device)
        # (W * rows, ...): the collective's layout of the W parts
        dist.reduce_scatter_tensor(out, parts.flatten(0, 1),
                                   op=dist.ReduceOp.AVG, group=self.group)
        return out

    @torch.no_grad()
    def all_reduce_mean(self, tensors: Dict[str, torch.Tensor],
                        key: str = "dp") -> Dict[str, torch.Tensor]:
        """The mean over ranks of each tensor: one all-reduce per dtype of
        the tensors flattened together, in the dict's order; returns views
        of the reduced buffers."""
        by_dtype: Dict[torch.dtype, List[str]] = {}
        for k, t in tensors.items():
            by_dtype.setdefault(t.dtype, []).append(k)
        out: Dict[str, torch.Tensor] = {}
        for keys in by_dtype.values():
            for k in keys:
                self._check(tensors[k])
            flat = torch.cat([tensors[k].reshape(-1) for k in keys])
            self._count("all_reduce", key, flat)
            if self.group is not None:
                dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self.group)
            off = 0
            for k in keys:
                n = tensors[k].numel()
                out[k] = flat[off:off + n].view(tensors[k].shape)
                off += n
        return {k: out[k] for k in tensors}

    @torch.no_grad()
    def all_reduce_sum(self, t: torch.Tensor, key: str = "") -> torch.Tensor:
        """The sum over ranks of `t`, in place."""
        self._check(t)
        self._count("all_reduce", key, t)
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def destroy(self) -> None:
        """Close the process group (the mesh is unusable after)."""
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None


def make_host_mesh() -> DataMesh:
    """World 1, no process group."""
    return DataMesh(None, 0, 1, None)


def init_data_mesh(backend: str, init_method: str = "env://",
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   timeout_s: float = 120.0) -> DataMesh:
    """Open the default process group and return its data mesh.  `nccl`
    needs a CUDA card (the rank's `LOCAL_RANK`, default 0, becomes the
    current device); `gloo` is for CPU tensors.  Without `world_size` /
    `rank`, `WORLD_SIZE` and `RANK` from the environment (torchrun)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl (CUDA) or gloo (CPU)")
    world = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs a CUDA device: use gloo for the "
                               "CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s), **kw)
    return DataMesh(dist.group.WORLD, rank, world, backend)


def data_axes(cfg: MeshConfig) -> Tuple[str, ...]:
    """The config's data axes: every axis that is not model or pipe."""
    return tuple(a for a in cfg.axes if a not in ("model", "pipe"))


def make_mesh_from_config(cfg: MeshConfig) -> DataMesh:
    """The data mesh `cfg` describes, over the open default process group
    (world 1 without one).  Its data extent must equal the group's
    world size.  A model axis > 1 (TP), a pipe axis and more than one
    data axis raise `NotImplementedError`."""
    if cfg.model_parallel > 1:
        raise NotImplementedError(f"model axis {cfg.model_parallel} (tensor "
                                  f"parallelism): {_NOT_PORTED}")
    if "pipe" in cfg.axes:
        raise NotImplementedError(f"pipe axis (pipeline parallelism, "
                                  f"hybrid meshes): {_NOT_PORTED}")
    if len(data_axes(cfg)) != 1:
        raise NotImplementedError(f"data axes {data_axes(cfg)}: meshes of "
                                  f"more than one data axis "
                                  f"(make_cluster_mesh) are {_NOT_PORTED}")
    (axis,) = data_axes(cfg)
    want = cfg.shape[cfg.axes.index(axis)]
    if not dist.is_initialized():
        if want != 1:
            raise RuntimeError(f"mesh data axis {want} needs an open "
                               f"process group (init_data_mesh)")
        return DataMesh(None, 0, 1, None, axis)
    world = dist.get_world_size()
    if world != want:
        raise ValueError(f"mesh data axis {want} != process group world "
                         f"size {world}")
    return DataMesh(dist.group.WORLD, dist.get_rank(), world,
                    dist.get_backend(), axis)
