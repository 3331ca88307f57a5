"""Collective schedules on rank-major tensors: the ring, tree, mixed-radix,
double-tree, pipelined-tree and k-ary allreduces, reduce-scatter,
allgather, alltoall(v), the rooted verbs, sendrecv, the hierarchical
schedules of a 2-D mesh and the schedule IR (``program``)."""

from rocnrdma_tpu_torch.collectives import program, schedule  # noqa: F401
from rocnrdma_tpu_torch.collectives.alltoall import (  # noqa: F401
    bruck_alltoall,
    fused_alltoallv,
    ragged_mask,
    rotation_alltoall,
)
from rocnrdma_tpu_torch.collectives.dtree import dbtree_allreduce  # noqa: F401
from rocnrdma_tpu_torch.collectives.fused import (  # noqa: F401
    fused_allgather,
    fused_allreduce,
    fused_alltoall,
    fused_broadcast,
    fused_gather,
    fused_reduce_scatter,
    fused_rooted_reduce,
    fused_scatter,
    fused_sendrecv,
)
from rocnrdma_tpu_torch.collectives.hierarchical import (  # noqa: F401
    hierarchical_allreduce,
    hierarchical_alltoall,
)
from rocnrdma_tpu_torch.collectives.khd import (  # noqa: F401
    khd2d_allgather,
    khd2d_allreduce,
    khd2d_reduce_scatter,
    khd_allgather,
    khd_allreduce,
    khd_reduce_scatter,
)
from rocnrdma_tpu_torch.collectives.ktree import (  # noqa: F401
    kary_tree_allreduce,
    sim_kary_allreduce,
)
from rocnrdma_tpu_torch.collectives.program import (  # noqa: F401
    Program,
    ProgramError,
    Step,
    execute as execute_program,
    prog_binomial_broadcast,
    prog_ring_allgather,
    prog_ring_allreduce,
    sim_program,
)
from rocnrdma_tpu_torch.collectives.ptree import ptree_allreduce  # noqa: F401
from rocnrdma_tpu_torch.collectives.reduce_op import (  # noqa: F401
    REDUCE_OPS,
    combine_fn,
    finalize,
    fused_reduce,
    identity,
)
from rocnrdma_tpu_torch.collectives.ring import (  # noqa: F401
    ring_allgather,
    ring_allreduce,
    ring_reduce_scatter,
)
from rocnrdma_tpu_torch.collectives.rooted import (  # noqa: F401
    binomial_broadcast,
    binomial_gather,
    binomial_reduce,
    binomial_scatter,
)
from rocnrdma_tpu_torch.collectives.tree import hd_allreduce  # noqa: F401
