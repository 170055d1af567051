"""Device mesh construction over a ``torch.distributed`` world.

Counterpart of the reference's ``parallel/mesh.py``.  Axis convention
(outermost -> innermost): ``dp``, ``pp``, ``sp``, ``tp``.  ``tp`` is
innermost so the tensor-parallel collectives (two all-reduces per layer)
ride the fastest links (NVLink inside a host); ``dp`` is outermost so data
parallelism, which talks least, is the axis that spans hosts.

Where the reference's mesh is an array of JAX devices driven by one
process, a device here is a rank: one process per card, ``make_mesh``
returns a ``DeviceMesh`` over the initialized world, and each rank asks it
for the groups it belongs to (``mesh.get_group("tp")``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

AXES = ("dp", "pp", "sp", "tp")
# how long the serving engine's control channel (the leader's op
# broadcasts over each serving group) may wait: as long as a server may
# sit idle.  A peer that dies still fails it at once, since its sockets
# close
CTRL_TIMEOUT_S = 7 * 24 * 3600.0


@dataclass(frozen=True)
class MeshShape:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    def as_tuple(self):
        return (self.dp, self.pp, self.sp, self.tp)


def _prime_factors(n: int):
    out = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def factor_devices(
    n_devices: int,
    max_tp: int = 0,
    max_sp: int = 0,
    max_pp: int = 0,
) -> MeshShape:
    """Factor ``n_devices`` over (tp, sp, pp, dp) in round-robin priority.

    ``max_*`` bound an axis (0 = unbounded); dp absorbs the rest.  tp gets
    factors first (its collectives are per-layer and latency-critical), then
    sp (ring per attention), then pp (per-microbatch boundary), then dp
    (once per step).
    """
    sizes = {"tp": 1, "sp": 1, "pp": 1, "dp": 1}
    caps = {"tp": max_tp, "sp": max_sp, "pp": max_pp, "dp": 0}
    order = ["tp", "sp", "pp", "dp"]
    for f in sorted(_prime_factors(n_devices)):
        for ax in order:
            cap = caps[ax]
            if cap == 0 or sizes[ax] * f <= cap:
                # dp is uncapped, so every factor lands somewhere
                sizes[ax] *= f
                order = order[order.index(ax) + 1 :] + order[: order.index(ax) + 1]
                break
    return MeshShape(**sizes)


def _world():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans an initialized torch.distributed world: call "
            "parallel.distributed.initialize(...) on every rank first")
    return dist


def mesh_over(shape: MeshShape):
    """A ``DeviceMesh`` with axes ``AXES`` over the world's first
    ``shape.n_devices`` ranks, in rank order.  Every rank of the world
    calls it.  Its device type follows the world's backend: ``cuda`` over
    NCCL, ``cpu`` over gloo (whose collectives run on the host).

    Beside the mesh's own groups, each serving group (the ``pp x tp``
    ranks of one ``(dp, sp)`` coordinate: the ranks of one serving
    engine) gets a gloo group with ``CTRL_TIMEOUT_S``, the mesh's
    ``ctrl_group`` on its members (None elsewhere), where the engine's
    leader broadcasts its ops; and, when ``pp > 1``, a group over the same
    ranks on the world's backend, the mesh's ``serve_group`` (with
    ``pp == 1`` the ``tp`` group is that group).  Both list their ranks
    ``pp``-major, ``tp``-minor."""
    import datetime

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    dist = _world()
    arr = torch.arange(shape.n_devices, dtype=torch.int64).reshape(
        shape.as_tuple())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, arr, mesh_dim_names=AXES)
    me = dist.get_rank()
    ctrl = serve = None
    timeout = datetime.timedelta(seconds=CTRL_TIMEOUT_S)
    # (dp, pp, sp, tp) -> (dp, sp, pp, tp): one row per serving group
    rows = arr.permute(0, 2, 1, 3).reshape(-1, shape.pp * shape.tp).tolist()
    for row in rows:
        g = dist.new_group(row, backend="gloo", timeout=timeout)
        if me in row:
            ctrl = g
    if shape.pp > 1:
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                serve = g
    mesh.ctrl_group = ctrl
    mesh.serve_group = serve
    return mesh


def make_mesh(shape: Optional[MeshShape] = None, **axis_sizes: int):
    """A 4-axis ``DeviceMesh`` ``(dp, pp, sp, tp)`` over the world.

    ``make_mesh()`` uses every rank with tp-first factorization;
    ``make_mesh(tp=2)`` / ``make_mesh(MeshShape(dp=2, tp=2))`` pin sizes.
    Raises when the world is smaller than the mesh and warns when it is
    larger (the ranks past the mesh then sit idle), as the reference does
    with devices.
    """
    dist = _world()
    n = dist.get_world_size()
    if shape is None:
        shape = MeshShape(**axis_sizes) if axis_sizes else factor_devices(n)
    if n < shape.n_devices:
        raise ValueError(
            f"mesh {shape} needs {shape.n_devices} devices, have {n}")
    if n > shape.n_devices:
        # pinned axis sizes that don't cover the world: surface it --
        # silently running on a subset wastes hardware
        warnings.warn(
            f"mesh {shape} uses {shape.n_devices} of {n} devices; "
            f"absorb the rest into dp",
            stacklevel=2,
        )
    return mesh_over(shape)
