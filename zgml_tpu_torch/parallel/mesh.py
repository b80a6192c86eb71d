"""The (dp, tp) mesh on torch.distributed, and the collectives the port runs over it.

Counterpart of zgml_tpu/parallel/mesh.py (15-51). The JAX package runs one
SPMD program over a device mesh under shard_map; the port runs one process
per rank, every rank the same host code on its own shard. A rank joins the
process group with ``init_distributed`` (the role of ``multihost_init``),
and ``make_mesh`` lays the world out as dp x tp, the inner axis varying
fastest (rank = i_dp * tp + i_tp, as mesh_utils' (dp, tp) array), with one
process group per axis: the ranks that share every other coordinate.

The backend is NCCL unless the caller names "gloo"; nothing switches it
for the caller. Each rank's device is cuda:(local_rank % device_count)
unless the caller asks for "cpu" (the CPU tests); ranks that outnumber the
cards share them, as the chip smoke's two gloo ranks share one card (NCCL
refuses two ranks on one device).

The collectives below are the only ones the port runs. Where gloo meets a
CUDA tensor the collective goes through host memory explicitly, each
direction counted under the profile counter ``host_copies`` (and its bytes
under ``host_copy_bytes``); NCCL and CPU tensors take no copy.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from zgml_tpu_torch.quant.packed import resolve_device
from zgml_tpu_torch.runtime.profile import global_profile

BACKENDS = ("nccl", "gloo")


def rank_device(device="cuda", local_rank: int | None = None) -> torch.device:
    """This rank's device: "cpu", or cuda:(local_rank % device_count) for
    "cuda" (local_rank from LOCAL_RANK, else the global rank, else 0). A
    CUDA device on a machine without one raises, naming it."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                        else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(backend: str = "nccl", init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     device="cuda") -> torch.device:
    """Join the process group (zgml_tpu.parallel.mesh.multihost_init's role)
    and return this rank's device (rank_device). rank and world_size default
    to RANK and WORLD_SIZE, init_method to env:// (MASTER_ADDR /
    MASTER_PORT). NCCL takes only CUDA devices."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend nccl runs on CUDA devices, not {dev}: name 'gloo' for the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 2-D mesh of the world's ranks. ``shape`` maps each axis name to its
    size, as the JAX Mesh's; ``coords`` this rank's index on each axis;
    ``groups`` the process group of each axis (the ranks that differ from
    this one on that axis alone); ``device`` where this rank computes."""
    shape: dict
    coords: dict
    groups: dict
    device: torch.device


def make_mesh(tp: int | None = None, dp: int | None = None, axis_names=("dp", "tp"),
              device=None) -> Mesh:
    """The world as a (dp, tp) mesh, JAX's defaults: tp the whole world
    where neither is given, the other axis the rest where one is; raises
    where dp * tp is not the world size. Collective over the world: every
    rank calls it (each axis group is made by every rank, in one order).
    device: this rank's device (rank_device's default where None)."""
    n = dist.get_world_size()
    if tp is None and dp is None:
        tp, dp = n, 1
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != {n} devices")
    outer, inner = axis_names
    rank = dist.get_rank()
    coords = {outer: rank // tp, inner: rank % tp}
    groups = {}
    for i in range(dp):                      # the inner axis: one row of the mesh
        g = dist.new_group([i * tp + j for j in range(tp)])
        if i == coords[outer]:
            groups[inner] = g
    for j in range(tp):                      # the outer axis: one column
        g = dist.new_group([i * tp + j for i in range(dp)])
        if j == coords[inner]:
            groups[outer] = g
    dev = rank_device("cuda" if device is None else device, rank)
    return Mesh({outer: dp, inner: tp}, coords, groups, dev)


# -- the collectives ---------------------------------------------------------------

def _through_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global_profile.add("host_copies")
    global_profile.add("host_copy_bytes", t.numel() * t.element_size())
    return t.cpu()


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    global_profile.add("host_copies")
    global_profile.add("host_copy_bytes", t.numel() * t.element_size())
    return t.to(dev)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (psum), as a new tensor; every
    rank gets the same bits."""
    if _through_host(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        return _to_device(h, t.device)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's tensors joined along `dim` in rank order (all_gather with
    tiled=True)."""
    src = _to_host(t) if _through_host(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return _to_device(out, t.device) if out.device != t.device else out


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank `src`'s t on every rank of the group (t gives the shape
    and dtype elsewhere), as a new tensor."""
    host = _through_host(t, group)
    buf = _to_host(t) if host else t.clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return _to_device(buf, t.device) if host else buf


def ring_shift(tensors: list[torch.Tensor], group, reverse: bool = False) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of the group, (i + 1) % n, and the
    previous rank's received in its place: lax.ppermute with the ring
    permutation [(j, (j + 1) % n)], through batch_isend_irecv; `reverse`
    the other way round, [(j, (j - 1) % n)] (a pipeline's backward)."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    step = -1 if reverse else 1
    nxt = dist.get_global_rank(group, (me + step) % n)
    prv = dist.get_global_rank(group, (me - step) % n)
    host = _through_host(tensors[0], group)
    srcs = [_to_host(t) if host else t.contiguous() for t in tensors]
    bufs = [torch.empty_like(s) for s in srcs]
    ops = [op for s, b in zip(srcs, bufs) for op in (dist.P2POp(dist.isend, s, nxt),
                                                     dist.P2POp(dist.irecv, b, prv))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dev = tensors[0].device
    return [_to_device(b, dev) for b in bufs] if host else bufs
