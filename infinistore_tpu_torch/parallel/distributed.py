"""The multi-process runtime: process-group init, hybrid meshes, the
collectives of one tensor-parallel group and the hand-offs of one
layer-sharded (pipeline) group.

Counterpart of the reference's ``parallel/distributed.py``.  The reference
wires up ``jax.distributed`` and lets one controller drive every device;
here every card is a rank of its own process and ``torch.distributed``
joins them.  The axes that talk per layer (tp) or per attention (sp) stay
inside a host; the once-per-step axis (dp) spans hosts.

``initialize()`` reads explicit arguments or torch's own environment
(``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as ``torchrun``
sets them) and is a no-op in a single process with nothing configured, so
the same launcher runs everywhere.  ``make_hybrid_mesh`` lays dp outermost
over the host groups.  ``TPGroup`` holds the collectives the tensor-parallel
forwards and the serving engine's mirror use (``models/llama.py``,
``engine/engine.py``); ``PPGroup`` a layer-sharded rank's hand-offs to its
neighbouring stages.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional, Sequence

from .mesh import AXES, MeshShape, factor_devices, mesh_over

# how long a collective of a compute group may wait before it raises: a
# dead or hung rank fails its peers' next step instead of hanging them
DEFAULT_TIMEOUT_S = 120.0


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Initialize the default process group (idempotent).

    Arguments default to torch's environment (``MASTER_ADDR`` -> the
    ``env://`` rendezvous, ``WORLD_SIZE``, ``RANK``).  A single process with
    nothing configured is a no-op.  ``backend`` defaults to ``nccl`` when
    CUDA is available, else ``gloo``.  ``timeout_s`` bounds every
    collective of the group: a rank that died makes the others raise."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    if init_method is None and world_size is None:
        return  # a single process: nothing to join
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def make_hybrid_mesh(
    shape: Optional[MeshShape] = None,
    *,
    dcn_dp: Optional[int] = None,
    **axis_sizes: int,
):
    """A (dp, pp, sp, tp) ``DeviceMesh`` that spans hosts.

    ``dcn_dp`` is the data-parallel degree across hosts (default: the
    number of hosts, world size over ``LOCAL_WORLD_SIZE`` as ``torchrun``
    sets it, else 1).  The ranks of one host group are contiguous and dp
    is outermost, so every tp group stays inside a host.  The per-group
    remainder is factored tp-first like ``make_mesh``; pinned axes are
    honoured exactly and dp absorbs the rest.  Example on 2 hosts x 4
    cards: ``make_hybrid_mesh(tp=2)`` -> dp=4 (2 across hosts x 2 inside),
    tp=2."""
    n_total = _world_size()
    if dcn_dp is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n_total))
        dcn_dp = max(1, n_total // max(1, local))
    if n_total % dcn_dp:
        raise ValueError(f"{n_total} ranks do not split into {dcn_dp} host "
                         f"groups")
    per_dcn = n_total // dcn_dp
    if shape is None:
        caps = dict(axis_sizes)
        unknown = set(caps) - set(AXES)
        if unknown:
            raise TypeError(f"unknown mesh axes: {sorted(unknown)}")
        if caps:
            pinned = {ax: caps.get(ax, 1) for ax in ("tp", "sp", "pp")}
            denom = pinned["tp"] * pinned["sp"] * pinned["pp"]
            if per_dcn % denom != 0:
                raise ValueError(
                    f"{per_dcn} devices per DCN group not divisible by "
                    f"tp*sp*pp = {denom}")
            dp = per_dcn // denom
            if "dp" in caps and caps["dp"] != dp:
                raise ValueError(
                    f"dp={caps['dp']} inconsistent: {per_dcn} devices per "
                    f"DCN group / (tp*sp*pp = {denom}) = {dp}")
            shape = MeshShape(dp=dp, **pinned)
        else:
            shape = factor_devices(per_dcn)
    full = MeshShape(dp=dcn_dp * shape.dp, pp=shape.pp, sp=shape.sp,
                     tp=shape.tp)
    if full.n_devices != n_total:
        raise ValueError(f"mesh {full} does not cover the {n_total} ranks")
    return mesh_over(full)


def process_local_batch(global_batch: int) -> int:
    """Per-process batch share (data loading happens per rank)."""
    n = _world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} processes")
    return global_batch // n


def _local_addresses() -> set:
    import socket

    addrs = {"127.0.0.1", "localhost", "::1"}
    try:
        hostname = socket.gethostname()
        addrs.add(hostname)
        for info in socket.getaddrinfo(hostname, None):
            addrs.add(info[4][0])
    except OSError:
        pass
    return addrs


def dcn_aware_store_targets(
    hosts: Sequence[str], my_rank: Optional[int] = None
) -> str:
    """Pick the store endpoint for this process: a host in the list that is
    THIS machine wins (the shm zero-copy path), otherwise rank-affine round
    robin over the others."""
    if not hosts:
        raise ValueError("no store hosts")
    local = _local_addresses()
    for h in hosts:
        if h in local:
            return h
    rank = _rank() if my_rank is None else my_rank
    return hosts[rank % len(hosts)]


class TPGroup:
    """The collectives of one tensor-parallel group, as the forwards and
    the serving engine use them.

    ``group`` carries the model's collectives (two all-reduces per layer,
    the logits' all-gather) and the store hop's page gathers; ``ctrl`` (a
    gloo group over the same ranks, with ``mesh.CTRL_TIMEOUT_S``) carries the
    leader's op broadcasts, so an idle server's followers wait on the
    host.  Over gloo, whose collectives run on the host, a CUDA tensor is
    staged through host memory (``host_staged``): such a group cannot run
    inside a CUDA graph.  Over NCCL the collectives run on the card and a
    CUDA graph captures them.  The group's rank 0 is the leader."""

    def __init__(self, group, ctrl=None):
        import torch.distributed as dist

        self.group = group
        self.ctrl = ctrl if ctrl is not None else group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.host_staged = self.backend == "gloo"
        self.leader = dist.get_global_rank(group, 0)

    @classmethod
    def from_mesh(cls, mesh) -> "TPGroup":
        """The group of the mesh's ``tp`` axis this rank belongs to."""
        return cls(mesh.get_group("tp"), mesh.ctrl_group)

    @classmethod
    def serving(cls, mesh) -> "TPGroup":
        """The ranks of this rank's serving engine: the ``pp x tp`` block
        of its ``(dp, sp)`` coordinate (``mesh_over``), ranked ``pp``-major,
        ``tp``-minor.  Its rank 0 (stage 0, tp rank 0) leads."""
        group = mesh.serve_group
        return cls(group if group is not None else mesh.get_group("tp"),
                   mesh.ctrl_group)

    @property
    def is_leader(self) -> bool:
        return self.rank == 0

    def _staged(self, x):
        return x.cpu() if self.host_staged and x.is_cuda else x

    def all_reduce(self, x):
        """Sum ``x`` over the group; every rank gets the same bits."""
        import torch.distributed as dist

        y = self._staged(x.contiguous())
        dist.all_reduce(y, group=self.group)
        return y.to(x.device) if y is not x else y

    def all_gather(self, x, dim: int):
        """The ranks' ``x`` concatenated along ``dim``, in rank order."""
        import torch
        import torch.distributed as dist

        y = self._staged(x.contiguous())
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=dim).to(x.device)

    def broadcast_(self, t) -> None:
        """The leader's ``t`` into every rank's ``t``, in place."""
        import torch.distributed as dist

        y = self._staged(t)
        dist.broadcast(y, src=self.leader, group=self.group)
        if y is not t:
            t.copy_(y)

    def gather_parts(self, x) -> Optional[list]:
        """On the leader: the ranks' ``x`` in rank order, on ``x``'s
        device; on the others: None."""
        import torch
        import torch.distributed as dist

        y = self._staged(x.contiguous())
        parts = ([torch.empty_like(y) for _ in range(self.size)]
                 if self.is_leader else None)
        dist.gather(y, parts, dst=self.leader, group=self.group)
        if not self.is_leader:
            return None
        return [p.to(x.device) for p in parts]

    def scatter_(self, out, chunks: Optional[List[Any]] = None) -> None:
        """Rank r receives the leader's ``chunks[r]`` into ``out``, in
        place (``chunks`` on the leader only)."""
        import torch.distributed as dist

        y = self._staged(out)
        src = None
        if self.is_leader:
            src = [self._staged(c.contiguous()) for c in chunks]
        dist.scatter(y, src, src=self.leader, group=self.group)
        if y is not out:
            out.copy_(y)

    def send_op(self, op) -> None:
        """The leader broadcasts one op (any picklable object)."""
        import torch.distributed as dist

        dist.broadcast_object_list([op], src=self.leader, group=self.ctrl)

    def recv_op(self):
        """A follower waits for the leader's next op."""
        import torch.distributed as dist

        box = [None]
        dist.broadcast_object_list(box, src=self.leader, group=self.ctrl)
        return box[0]

    def gather_objects(self, obj) -> Optional[list]:
        """Every rank's ``obj`` in rank order on the leader; None
        elsewhere."""
        import torch.distributed as dist

        out = [None] * self.size if self.is_leader else None
        dist.gather_object(obj, out, dst=self.leader, group=self.ctrl)
        return out


class PPGroup:
    """One rank's stage of a layer-sharded (pipeline) serving group: the
    contiguous layer range it holds, the hidden state's hand-off to the
    next stage and the logits' broadcast from the last.

    ``group`` is the mesh's ``pp`` group of this rank (the ranks with its
    ``tp`` index, one per stage, in stage order).  Stage ``s`` holds layers
    ``[s * L/pp, (s + 1) * L/pp)``.  A forward runs its stages in sequence:
    stage 0 embeds, each stage runs its layers and sends the hidden state
    ``[B, S, dim]`` to the next (a point-to-point send; every tp rank of a
    stage sends its own, identical copy to its counterpart), the last
    applies the final norm and the LM head, and its logits reach every
    stage by a broadcast.  Over gloo a CUDA tensor is staged through host
    memory (``host_staged``); over NCCL a CUDA graph captures the
    hand-offs."""

    def __init__(self, group, n_layers: int):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.stage = dist.get_rank(group)
        if n_layers % self.size:
            raise ValueError(f"n_layers={n_layers} must divide over "
                             f"pp={self.size}")
        self.n_local = n_layers // self.size
        self.first_layer = self.stage * self.n_local
        self.backend = str(dist.get_backend(group))
        self.host_staged = self.backend == "gloo"
        self._ranks = [dist.get_global_rank(group, s)
                       for s in range(self.size)]

    @classmethod
    def from_mesh(cls, mesh, n_layers: int) -> "PPGroup":
        """The group of the mesh's ``pp`` axis this rank belongs to."""
        return cls(mesh.get_group("pp"), n_layers)

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.size - 1

    def send_next(self, x) -> None:
        """``x`` to the next stage (blocks until it is taken over gloo)."""
        import torch.distributed as dist

        y = x.contiguous()
        if self.host_staged and y.is_cuda:
            y = y.cpu()
        dist.send(y, dst=self._ranks[self.stage + 1], group=self.group)

    def recv_prev(self, shape, dtype, device):
        """The previous stage's ``send_next`` tensor of ``shape``."""
        import torch
        import torch.distributed as dist

        staged = self.host_staged and torch.device(device).type == "cuda"
        y = torch.empty(shape, dtype=dtype,
                        device="cpu" if staged else device)
        dist.recv(y, src=self._ranks[self.stage - 1], group=self.group)
        return y.to(device) if staged else y

    def broadcast_last_(self, t) -> None:
        """The last stage's ``t`` into every stage's ``t``, in place."""
        import torch.distributed as dist

        y = t.cpu() if self.host_staged and t.is_cuda else t
        dist.broadcast(y, src=self._ranks[-1], group=self.group)
        if y is not t:
            t.copy_(y)
