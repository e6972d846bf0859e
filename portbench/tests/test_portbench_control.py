"""The control fails where the program passes. The control is the plain
reference computed in float32 with TF32 operands (the precision below the
port's), put in the program's place: a whole run of the cell through
run.py's `run_cell` reads `correct` false, and the port's run reads it
true. The readings that the limit lies between, at a size a test run
holds: the port's stacked decode within it, the control above it. On
the CPU, and on the card where there is one; portbench/control.py takes
the readings on the card at the cell's own size."""

import json
import os

import pytest

from portbench.tests.small_run import PB, control_decode, run

NAME = "vardct_epf2_3mp"
SIZE = {"height": 256, "width": 512}
READINGS_SIZE = {"height": 512, "width": 1024}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    return "cuda"


@pytest.fixture(autouse=True)
def stream_cache(tmp_path, monkeypatch):
    from portbench.streams import pool

    monkeypatch.setattr(pool, "CACHE", str(tmp_path))


def control_run(device):
    result, limit = run(NAME, SIZE, control_decode(NAME, SIZE), device)
    assert result["correct"] is False, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["max_abs_gap"]["value"] > limit


def test_the_control_in_the_programs_place_is_not_correct_on_the_cpu():
    control_run("cpu")


@pytest.mark.cuda
def test_the_control_in_the_programs_place_is_not_correct(card):
    control_run(card)


@pytest.mark.cuda
def test_the_port_is_correct_on_the_card(card):
    result, _ = run(NAME, SIZE, device=card)
    assert result["correct"] is True, result["checks"]


def readings(device):
    from portbench import control

    with open(os.path.join(PB, "configs", f"{NAME}.json")) as f:
        config = json.load(f)
    with open(os.path.join(PB, "traffic", "loader_b16.json")) as f:
        traffic = json.load(f)
    config["params"].update(READINGS_SIZE)
    limit = config["limits"]["max_abs_gap"]
    got = control.readings(config, traffic, 2**31 + 21, 4, device)
    assert got["port_max"] <= limit < got["control_min"], got


def test_readings_on_either_side_of_the_limit_on_the_cpu():
    readings("cpu")


@pytest.mark.cuda
def test_readings_on_either_side_of_the_limit(card):
    readings(card)
