"""On the card: the control, the reference in float32 with TF32
products in the program's place, comes out not correct against each cell's limits, on
three seeds, while the program itself is correct on them.  The cells run
at their own widths with fewer queries, samples and pairs.

    python -m pytest vobench/tests/test_vobench_card.py -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from vobench_tiny import bench

pytestmark = pytest.mark.requires_cuda

SMALLER = {
    "reloc": ({}, {"queries": 1, "samples": 1024, "check_answers": 1}),
    "pointtrack": ({}, {"frames": 6, "check_pairs": 1, "check_table_pairs": 4}),
}
SEEDS = (11, 12, 13)


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    import invcompcamtrack_torch  # noqa: F401  (sets TF32 off)

    return torch


def _cell(name):
    from vobench import harness

    cell = harness.Cell(bench(), name)
    config, params = SMALLER[cell.spec["kind"]]
    cell.config = dict(cell.config, **config)
    cell.params = dict(cell.params, **params)
    return cell


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(card, name, seed):
    from vobench import harness

    cell = _cell(name)
    sync = card.cuda.synchronize
    ctx = SimpleNamespace(seed=seed, device=card.device("cuda"), params=cell.params,
                          config=cell.config, limits=cell.limits, sync=sync,
                          quiet=harness.Trace(False, sync), phases={})
    st = cell.kind.setup(ctx)
    units = max(2, cell.params.get("check_table_pairs", 0))
    records = [cell.kind.unit(st, i, ctx.quiet) for i in range(units)]
    cell.kind.release(st)
    program = cell.kind.check(st, records)
    assert all(v["value"] <= v["limit"] for v in program.values()), program
    control = cell.kind.control(st, records)
    failed = {k: v for k, v in control.items() if not v <= cell.limits[k]}
    assert failed, (control, cell.limits)
