"""Multi-GPU training and inference: a ``(data, model)`` mesh of ranks over
PyTorch process groups (:mod:`.mesh`) and the multistage cascade as a GPipe
pipeline over devices (:mod:`.pipeline`).  Port of ``dream_tpu/parallel``."""

from dream_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    param_shardings,
    process_local_batch,
    replicated_sharding,
    shard_params,
)
from dream_tpu_torch.parallel.pipeline import (
    make_pipeline_mesh,
    pipeline_multistage_inference,
)
