"""The port's sharded decode across processes: tools/torch_multihost_check.py
starts HOSTS processes under torch.distributed (gloo, CPU shards), each
holding its CHIPS shards of one ("hosts", "chips") mesh; the halos at the
process borders go point to point and every rank ends with the whole
frame. Each rank's decodes of epf3_512 (row bands) and wide_epf_1024x256
(column bands) must equal its single-device decodes bit for bit."""

import json
import os
import subprocess
import sys

import pytest

import torch_parity as tp

SCRIPT = os.path.join(tp.REPO, "tools", "torch_multihost_check.py")


@pytest.mark.parametrize("hosts,chips", [(2, 1), (2, 2)])
def test_sharded_decode_across_processes(hosts, chips):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(
        [sys.executable, SCRIPT, "--hosts", str(hosts), "--chips",
         str(chips), "--timeout", "200"],
        cwd=tp.REPO, env=env, capture_output=True, text=True, timeout=240)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and res["ok"], res
    assert len(res["workers"]) == hosts
    for w in res["workers"]:
        for name, f in w["fixtures"].items():
            assert f["equal"] and f["max_abs_diff"] == 0.0, (name, f)
            # every border between processes carried halo rows
            assert f["process_bytes"] > 0
            assert f["bytes"] > f["process_bytes"] or chips == 1
