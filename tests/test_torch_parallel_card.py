"""The port's ``parallel/`` on the card: a ``torch.distributed`` world of
one rank (``"cpu:gloo,cuda:nccl"`` where the build has NCCL), the card's
mesh against the same world's CPU mesh. Skips without a card; imports no
JAX (the 2- and 4-rank CPU worlds and the JAX parity are in
``tests/test_torch_parallel.py``)."""

from datetime import timedelta

import numpy as np
import pytest
import torch.distributed as dist

import torch_parallel_worker as tpw
from torch_parity import _torch_threads, cuda  # noqa: F401
from visionworkbench_torch.parallel import hierarchical_sharded_correlate, make_tile_mesh


@pytest.mark.cuda
def test_world_of_one_card_matches_cpu(cuda, tmp_path):
    """A world of 1 on the card (NCCL for CUDA tensors where the build has
    it): hierarchical BM with mask, L<->R and parabola, and hierarchical
    SGM, against the same world's CPU mesh; validity and integer winners
    equal, the parabola within 1e-4."""
    backend = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        for case in ("bm_jax", "sgm"):
            left, right, sr, kw, _ = tpw.hier_case(case)
            runs = [hierarchical_sharded_correlate(left, right, sr, make_tile_mesh(device=d),
                                                   **kw).to_numpy()
                    for d in ("cuda", "cpu")]
            np.testing.assert_array_equal(runs[0][1], runs[1][1])
            np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=0, atol=1e-4)
    finally:
        dist.destroy_process_group()
