"""Multi-device serving over ``torch.distributed``: mesh construction, the
process-group runtime and tensor-parallel sharding.

Counterpart of the reference's ``parallel/`` package, as far as the port
goes: one process per card, explicit collectives, the tensor-parallel
serving path (``engine.InferenceEngine(mesh=...)``, ``serve --tp``).  Not
ported yet, and listed in ``ROADMAP.md``: ``make_sp_prefill`` with ring
attention (``ring.py``, ``layers.py``: ``make_ring_attention``,
``tp_layer_forward``), the pipeline (``spmd_pipeline``), training
(``make_train_step``) and expert parallelism (``make_moe_*``).
"""

from .distributed import (
    TPGroup,
    dcn_aware_store_targets,
    initialize,
    make_hybrid_mesh,
    process_local_batch,
)
from .mesh import AXES, MeshShape, factor_devices, make_mesh
from .sharding import (
    check_tp_heads,
    llama_inference_specs,
    make_tp_decode,
    make_tp_prefill,
    shard_leaf,
    shard_params,
)

__all__ = [
    "AXES",
    "MeshShape",
    "TPGroup",
    "check_tp_heads",
    "dcn_aware_store_targets",
    "factor_devices",
    "initialize",
    "llama_inference_specs",
    "make_hybrid_mesh",
    "make_mesh",
    "make_tp_decode",
    "make_tp_prefill",
    "process_local_batch",
    "shard_leaf",
    "shard_params",
]
