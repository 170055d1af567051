"""Multi-device serving over ``torch.distributed``: mesh construction, the
process-group runtime, tensor- and layer-sharded serving and
sequence-parallel prefill.

Counterpart of the reference's ``parallel/`` package, as far as serving
goes: one process per card, explicit collectives.

* ``InferenceEngine(mesh=...)`` / ``serve --tp N --pp M``: the serving
  group of a ``(pp, tp)`` mesh (``TPGroup.serving``) runs one engine, its
  rank 0 leading and the others following its ops.  Each rank holds its
  stage's layers (``PPGroup``: hidden-state hand-offs between stages, the
  logits broadcast from the last) and its Megatron slice of each
  (``TPGroup``: two all-reduces per layer, the logits' all-gather).
  Speculation and a LoRA bank run there too: the draft beside the group on
  its leader, the bank sharded as the weights are.
* ``make_sp_prefill``: a long prompt's prefill spread over the mesh's
  ``sp`` axis by ring attention (``ring.py``, ``layers.py``:
  ``make_ring_attention``, ``ring_attention_local``,
  ``tp_layer_forward``); its KV goes into an engine through
  ``InferenceEngine.adopt_prefill``.

On the CPU the ranks join over gloo; on cards over NCCL (gloo lets ranks
share one card, its collectives crossing the host).  Not ported yet, and
listed in ``ROADMAP.md``: training (``tp_cross_entropy``,
``make_train_step``), the pipeline schedule (``spmd_pipeline``) and expert
parallelism (``make_moe_*``).
"""

from .distributed import (
    PPGroup,
    TPGroup,
    dcn_aware_store_targets,
    initialize,
    make_hybrid_mesh,
    process_local_batch,
)
from .layers import tp_layer_forward
from .mesh import AXES, MeshShape, factor_devices, make_mesh
from .ring import make_ring_attention, ring_attention_local
from .sharding import (
    check_tp_heads,
    llama_inference_specs,
    make_sp_prefill,
    make_tp_decode,
    make_tp_prefill,
    shard_leaf,
    shard_params,
)

__all__ = [
    "AXES",
    "MeshShape",
    "PPGroup",
    "TPGroup",
    "check_tp_heads",
    "dcn_aware_store_targets",
    "factor_devices",
    "initialize",
    "llama_inference_specs",
    "make_hybrid_mesh",
    "make_mesh",
    "make_ring_attention",
    "make_sp_prefill",
    "make_tp_decode",
    "make_tp_prefill",
    "process_local_batch",
    "ring_attention_local",
    "shard_leaf",
    "shard_params",
    "tp_layer_forward",
]
