"""Parallelism over ``torch.distributed``: one process per card.

The ported part of ``rovit_kan_tpu/parallel``: the 1-D data mesh and the
2-D data x model mesh (``mesh.py``), their multi-host glue, FSDP
(``fsdp.py``) and tensor and sequence parallelism (``tensor.py``). Not
ported: expert parallelism (``make_moe_mesh``, ``moe_param_specs``) and the
GPipe pipeline (``pipeline.py``).
"""
from rovit_kan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_2d_mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from rovit_kan_tpu_torch.parallel.multihost import (  # noqa: F401
    any_process,
    barrier,
    broadcast_one_to_all,
    global_mesh,
    local_batch_slice,
    make_global_array,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
