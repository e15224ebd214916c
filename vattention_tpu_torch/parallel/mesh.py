"""This rank's place in the serving mesh, and the collectives of a step.

Counterpart of ``vattention_tpu/parallel/mesh.py``.  The JAX package runs
one controller over a ``(dp, pp, tp)`` device mesh and compiles the
collectives into the step (``psum`` after the row-parallel projections,
``ppermute`` between pipeline stages).  The port runs one process per rank
under ``torch.distributed``, as the reference's workers do: ``ServingMesh``
is this rank's ``(dp, pp, tp)`` coordinates, with tp innermost and
``make_serving_mesh``'s arithmetic (rank = (dp * pp + pp_rank) * tp +
tp_rank), its tensor-parallel group, its pipeline neighbours, its device,
and the three collectives the step needs: an all-reduce over tp, the
activations sent to the next stage and received from the previous one,
and the broadcast of the packed samples from the sampling rank (the last
stage's tp-rank 0) to every rank.  The port serves one replica over
the whole process group (dp 0); ``mesh_coords`` and ``mesh_rank`` keep the
JAX arithmetic with its dp axis.

The backend follows the layout by one rule (``pick_backend``): ``nccl``
when each rank owns a CUDA device, ``gloo`` when ranks share a device or
run on the CPU (NCCL refuses two ranks on one device).  Under gloo a
collective on a CUDA tensor is staged through a pinned host buffer, copied
out and back by the step itself: gloo's own handling of CUDA tensors is
not relied on.  Under nccl the collectives take the CUDA tensors as they
are, so a step that holds them can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)

def pick_backend(device_type: str, ranks_per_device: int) -> str:
    """``nccl`` when every rank owns a CUDA device, else ``gloo``."""
    if device_type == "cuda" and ranks_per_device == 1:
        return "nccl"
    return "gloo"


def ranks_per_device(world_size: int, device_type: str,
                     device_count: Optional[int] = None) -> int:
    """How many of ``world_size`` ranks on one host share a device when
    rank r takes ``cuda:{r % device_count}`` (all of them on the CPU)."""
    if device_type != "cuda":
        return world_size
    n = torch.cuda.device_count() if device_count is None else device_count
    if n < 1:
        raise RuntimeError("no CUDA device for the ranks")
    return -(-world_size // n)


def mesh_coords(rank: int, tensor_parallel_size: int,
                pipeline_parallel_size: int) -> Tuple[int, int, int]:
    """(dp, pp, tp) of ``rank`` with tp innermost."""
    tp = rank % tensor_parallel_size
    pp = (rank // tensor_parallel_size) % pipeline_parallel_size
    dp = rank // (tensor_parallel_size * pipeline_parallel_size)
    return dp, pp, tp


def mesh_rank(dp: int, pp: int, tp: int, tensor_parallel_size: int,
              pipeline_parallel_size: int) -> int:
    return (dp * pipeline_parallel_size + pp) * tensor_parallel_size + tp


class ServingMesh:
    """This process's rank in a ``(dp, pp, tp)`` mesh over the default
    process group, which must be initialized (``multihost.init_multihost``)
    and holds one replica (dp 0).  Every rank constructs its mesh at the
    same point: the tp groups are created collectively."""

    def __init__(self, tensor_parallel_size: int = 1,
                 pipeline_parallel_size: int = 1, *,
                 device: torch.device):
        if not dist.is_initialized():
            raise RuntimeError(
                "ServingMesh needs an initialized process group "
                "(parallel.multihost.init_multihost)")
        self.tp_size = tensor_parallel_size
        self.pp_size = pipeline_parallel_size
        world = self.tp_size * self.pp_size
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"process group of {dist.get_world_size()} ranks for a "
                f"pp {self.pp_size} x tp {self.tp_size} mesh")
        self.rank = dist.get_rank()
        self.dp_rank, self.pp_rank, self.tp_rank = mesh_coords(
            self.rank, self.tp_size, self.pp_size)
        self.device = device
        self.backend = dist.get_backend()
        # gloo collectives on CUDA tensors go through pinned host buffers
        self.staged = self.backend == "gloo" and device.type == "cuda"
        if self.backend == "nccl" and device.type != "cuda":
            raise RuntimeError("nccl needs each rank on a CUDA device")

        def rank_of(dp, pp, tp):
            return mesh_rank(dp, pp, tp, self.tp_size, self.pp_size)

        # groups are created by every rank, in the same order
        self.tp_group = None
        if self.tp_size > 1:
            for p in range(self.pp_size):
                ranks = [rank_of(0, p, t) for t in range(self.tp_size)]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.tp_group = group
        self.prev_rank = (rank_of(self.dp_rank, self.pp_rank - 1,
                                  self.tp_rank)
                          if self.pp_rank > 0 else None)
        self.next_rank = (rank_of(self.dp_rank, self.pp_rank + 1,
                                  self.tp_rank)
                          if self.pp_rank < self.pp_size - 1 else None)
        self.sampling_rank = rank_of(self.dp_rank, self.pp_size - 1, 0)
        self._host: Dict[tuple, torch.Tensor] = {}
        logger.info(
            "rank %d of %d: dp %d pp %d tp %d on %s, backend %s (%s)",
            self.rank, world, self.dp_rank, self.pp_rank, self.tp_rank,
            device, self.backend,
            "collectives staged through pinned host buffers"
            if self.staged else "collectives on the tensors as they are")

    # ------------------------------------------------------------------ #
    @property
    def is_first_stage(self) -> bool:
        return self.pp_rank == 0

    @property
    def is_last_stage(self) -> bool:
        return self.pp_rank == self.pp_size - 1

    @property
    def is_sampling_rank(self) -> bool:
        return self.rank == self.sampling_rank

    @property
    def is_driver(self) -> bool:
        return self.rank == 0

    @property
    def captures_steps(self) -> bool:
        """Whether a step may be captured in a CUDA graph: under nccl.  Gloo
        runs its collectives from the host, which a graph cannot hold, so
        under gloo every step runs eagerly."""
        return self.backend == "nccl"

    def _host_buffer(self, like: torch.Tensor, slot: str) -> torch.Tensor:
        key = (slot, like.dtype, like.numel())
        buf = self._host.get(key)
        if buf is None:
            buf = self._host[key] = torch.empty(
                like.numel(), dtype=like.dtype, pin_memory=True)
        return buf.view(like.shape)

    # ------------------------------------------------------------------ #
    def all_reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over this rank's tp group, in place (the JAX model's
        ``psum`` over "tp")."""
        if self.tp_size == 1:
            return x
        if self.staged:
            host = self._host_buffer(x, "tp")
            host.copy_(x)
            dist.all_reduce(host, group=self.tp_group)
            x.copy_(host)
        else:
            dist.all_reduce(x, group=self.tp_group)
        return x

    def send_next(self, x: torch.Tensor) -> None:
        """Send a microbatch's activations to the next stage (the JAX
        pipeline's ``ppermute``)."""
        if self.staged:
            host = self._host_buffer(x, "send")
            host.copy_(x)
            dist.send(host, self.next_rank)
        else:
            dist.send(x.contiguous(), self.next_rank)

    def recv_prev(self, shape: Sequence[int],
                  dtype: torch.dtype) -> torch.Tensor:
        """The previous stage's activations for the next microbatch."""
        x = torch.empty(tuple(shape), dtype=dtype, device=self.device)
        if self.staged:
            host = self._host_buffer(x, "recv")
            dist.recv(host, self.prev_rank)
            x.copy_(host)
        else:
            dist.recv(x, self.prev_rank)
        return x

    def broadcast_samples(self, samples: Optional[torch.Tensor],
                          shape: Sequence[int]) -> torch.Tensor:
        """The sampling rank's packed samples on every rank: a host tensor under gloo, a device tensor under nccl."""
        if self.staged:
            host = self._host_buffer(
                torch.empty(tuple(shape), dtype=torch.int32, device="meta"),
                "samples")
            if self.is_sampling_rank:
                host.copy_(samples)
            dist.broadcast(host, self.sampling_rank)
            # a fresh tensor: the caller keeps it while later steps reuse
            # the buffer
            return host.clone()
        if not self.is_sampling_rank:
            samples = torch.empty(tuple(shape), dtype=torch.int32,
                                  device=self.device)
        dist.broadcast(samples, self.sampling_rank)
        return samples

    def all_reduce_min(self, values: Sequence[int]) -> list:
        """The element-wise minimum of ``values`` over every rank (the
        memory profile: co-located ranks see different free bytes, and
        every rank's scheduler and allocator must agree)."""
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor(list(values), dtype=torch.int64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return [int(v) for v in t.tolist()]


def make_serving_mesh(tensor_parallel_size: int = 1,
                      pipeline_parallel_size: int = 1, *,
                      device: torch.device) -> ServingMesh:
    """This rank's ``(pp, tp)`` mesh over the initialized process group
    (the JAX ``make_serving_mesh`` at dp 1, tp innermost)."""
    return ServingMesh(tensor_parallel_size, pipeline_parallel_size,
                       device=device)
