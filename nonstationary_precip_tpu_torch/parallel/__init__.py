"""Counterpart of nonstationary_precip_tpu.parallel, on torch.distributed:
one process per device, NCCL on CUDA and gloo on the CPU (``mesh``),
JAX's collectives with their transposes (``collectives``) and one spawn
helper (``launch``, imported by name: ``python -m`` runs it)."""

from nonstationary_precip_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    data_sharding,
    init_world,
    make_mesh,
    make_mesh_2d,
    replicated,
    tile,
)
from nonstationary_precip_tpu_torch.parallel.dp import (  # noqa: F401
    dp_value_and_grad,
    pad_to_multiple,
    shard_batch,
)
from nonstationary_precip_tpu_torch.parallel.distributed_chol import (  # noqa: F401
    sharded_cholesky,
    sharded_cholesky_2d,
    sharded_mvn_logpdf,
)
from nonstationary_precip_tpu_torch.parallel.sharded_cg import (  # noqa: F401
    make_sharded_chunked_mll,
    sharded_cg_mll,
    sharded_cg_posterior,
    sharded_posterior_query,
    sharded_posterior_state,
)
from nonstationary_precip_tpu_torch.parallel.sharded_predict import sharded_marginals  # noqa: F401
from nonstationary_precip_tpu_torch.parallel.sharded_sgpr import (  # noqa: F401
    sharded_sgpr_loss,
    sharded_sgpr_value_and_grad,
)
