from simple_hrnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, replicate, shard_batch)
from simple_hrnet_tpu_torch.parallel import distributed  # noqa: F401
