from .mesh import make_mesh, sharded_align_batch, distributed_init  # noqa: F401
from .bucketing import bucket_pairs  # noqa: F401
