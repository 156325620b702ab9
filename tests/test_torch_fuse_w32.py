"""K3's plain version against the Pallas ``fuse_up`` at the high-res
branch shape of HRNet-W32 256x192 (1, 64, 48, 32), with the sources of
stage 2 (1), 3 (2) and 4 (3), on the CPU. Tolerance: the house 2e-4.
"""

import pytest
from torch_port_threads import torch_two_threads  # noqa: F401 (autouse)

from test_torch_kernels import check_fuse_up_plain_against_jax


@pytest.mark.parametrize('n_src', [1, 2, 3], ids=['w32-1', 'w32-2', 'w32-3'])
def test_fuse_up_plain_matches_jax_fuse_up_at_w32(n_src):
    check_fuse_up_plain_against_jax(n_src, 1, 64, 48, 32)
