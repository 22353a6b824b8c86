"""On the card: each cell's comparison passes the program and fails its
control, the reference put in the program's place and computed with TF32 on
(the precision below the configurations' float32), at the cell's own
widths and with as many units as a run compares, on three seeds. Each
seed's readings of both print as one JSON line; the limits in the traffic
mixes were set from them.

    python3 -m pytest benchmark/tests -m cuda -s [--seeds 1 2 3] [--cells re10k-train]
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from benchmark.harness import kinds, serving, spec

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


def readings(cell: spec.Cell, seed: int, device: torch.device) -> dict:
    """The cell's set-up, the units a run compares, then the comparison of
    the program's outputs and of the control's with the reference."""
    t0 = time.perf_counter()
    with serving.precision(False):
        driver = kinds.find(cell.traffic["kind"])(cell, seed, device)
        driver.warm()
        samples = [driver.run_unit(i, keep=True) for i in range(cell.traffic["check"].get("sample", 0))]
        driver.release()
        program = driver.compare(samples)
        control = driver.compare(samples, control=True)
    del driver, samples
    serving.free(device)
    return {"workload": cell.name, "seed": seed, "program": program, "control": control,
            "seconds": time.perf_counter() - t0, "device": torch.cuda.get_device_name(device)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes_and_the_control_fails(cuda_device, control_seeds, control_cells, name):
    if control_cells and name not in control_cells:
        pytest.skip(f"--cells leaves out {name}")
    cell = spec.cell(spec.load_spec(), name)
    limits = cell.traffic["check"]["limits"]
    rows = []
    for seed in control_seeds:
        rows.append(readings(cell, seed, cuda_device))
        print(json.dumps(rows[-1]), flush=True)
    for row in rows:
        assert all(row["program"][k] <= limits[k] for k in limits), row
        assert any(row["control"][k] > limits[k] for k in limits), row
