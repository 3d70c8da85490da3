"""The copied simstep byte count and the index sizes it reads."""
import numpy as np
import pytest
import torch

import simbench_tiny  # noqa: F401  (paths)
from simbench import simstep_bytes as sb


def test_dense_tile_bytes_match_chip_smoke():
    sizes = sb.index_sizes(np.repeat(np.arange(50000), 10), 50000)
    assert sb.launch_bytes(sizes, per_row=False) == 7_166_676


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_sizes_match_the_port(seed):
    from repro_torch.kernels.simstep.ops import row_index
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 3000, 40) * (rng.uniform(size=40) < 0.8)
    lengths[:5] = rng.integers(1, 40, 5)
    vm = []
    for r in rng.permutation(40):
        if rng.uniform() < 0.3:
            vm += [-1] * int(rng.integers(1, 4))
        vm += [int(r)] * int(lengths[r])
    vm = np.asarray(vm + [-1], np.int32)
    index = row_index(torch.from_numpy(vm), 40)
    sizes = sb.index_sizes(vm, 40)
    assert sizes["n_windows"] + 1 == index.window.numel()
    assert sizes["n_empty"] == index.empty.numel()
    assert sizes["n_chunks"] == index.chunk_row.numel()
    assert sizes["n_long"] == int(index.chunk_first.unique().numel())
