"""The control on the card: the reference standing in the program's place,
computed with TF32 on (the precision below the configurations' f32 with
TF32 off), fails the cell's limits, while the program passes them; at a
size a test run holds (16,384 users, 12,288 items, 0.9M interactions; the
cells' own widths). Runs only where a card is visible:

    python3 -m pytest -m cuda benchmark/tests -q
"""

from __future__ import annotations

import pytest

from conftest import load_benchmark

SMALL_LOG = {"num_users": 16_384, "num_items": 12_288,
             "interactions": 900_000}


def small_cell(name: str):
    from benchmark.harness import cells

    cell = cells.load_cell(name, load_benchmark())
    cell.log = {**cell.log, **SMALL_LOG}
    if cell.kind == "refresh":
        cell.traffic = {**cell.traffic, "request_users": 1024}
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gowalla.train", "yelp.train",
                                  "gowalla.serve", "yelp.serve"])
def test_control_fails_and_program_passes(name, card):
    from benchmark import readings
    from benchmark.harness import oracle

    cell = small_cell(name)
    fn = readings.train_readings if cell.kind == "train" \
        else readings.serve_readings
    for seed in (21, 22, 23):
        out = fn(cell, seed, card, control=True, bf16=False)
        numbers = dict(out["program"])
        if "batch_faults" in out:
            numbers["batch_faults"] = out["batch_faults"]
        assert oracle.judge(numbers, cell.limits)["correct"], out
        assert not oracle.judge(out["control_tf32"],
                                cell.limits)["correct"], out
