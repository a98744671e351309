"""The port's dry run on the two-pod production mesh (2 x 16 x 16): every
cell's status is the reference's `supported_shapes` rule and its per-rank
bytes of each argument kind equal the reference's shard-shape sums, as
`test_torch_dryrun.py` (b) holds them at 16 x 16. A file of its own, so
that the two meshes' cells run on two test workers."""

from __future__ import annotations

import pytest

from repro.configs.registry import ARCHS

from test_torch_dryrun import check_production_cells


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_cells_pod2_match_shard_shapes(arch):
    check_production_cells(arch, True)
