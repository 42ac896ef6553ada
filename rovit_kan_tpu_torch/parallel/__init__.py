"""Parallelism over ``torch.distributed``: one process per card.

The port of ``rovit_kan_tpu/parallel``: the 1-D data mesh, the 2-D
data x model, data x expert and data x pipe meshes and the 3-D data x pipe
x model mesh (``mesh.py``), their multi-host glue, FSDP (``fsdp.py``),
tensor, sequence and expert parallelism (``tensor.py``) and the GPipe
pipeline, whose stages are tensor-parallel on the 3-D mesh
(``pipeline.py``). Serving over a mesh is ``serving.py``'s.
"""
from rovit_kan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_2d_mesh,
    make_mesh,
    make_moe_mesh,
    make_pipeline_mesh,
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
