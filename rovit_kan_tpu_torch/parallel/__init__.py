"""Data parallelism over ``torch.distributed``: one process per card.

The ported part of ``rovit_kan_tpu/parallel``: the 1-D data mesh, its
multi-host glue and FSDP over it (``parallel/fsdp.py``). Tensor and
sequence parallelism, expert parallelism and the GPipe pipeline are not
ported.
"""
from rovit_kan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
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
