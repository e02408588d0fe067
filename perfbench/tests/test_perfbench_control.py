"""The control: the plain reference in the precision below the
configuration's, put in the program's place, has to fail the limits.

On the CPU at the tests' small size (float32, the control in bfloat16),
on three seeds; on the card at each cell's own size, on three seeds
(``card``: skips without a CUDA device)."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import check, harness, weights
from perfbench.reference import Reference
from perfbench.tests.conftest import ROOT

CELLS = ["line.v15-bf16", "scene.v15-f32"]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_control_fails_at_small_size(tiny_root, tmp_path, seed):
    sys.path.insert(0, str(ROOT / "perfbench"))
    import calibrate
    torch.set_num_threads(2)
    cell = harness.load_cell(tiny_root, "line.tiny")
    cfg = cell.config
    prog = harness.Program(cell, seed, "cpu", tmp_path)
    records = [prog.serve(c) for c in calibrate.compared_calls(cell.mix,
                                                               seed)]
    harness.host_codes(records)
    p32 = weights.make(cfg, seed, "cpu", torch.float32)
    ref = Reference(p32, cfg)
    ref.set_prompt(prog.prompt)
    low = calibrate.control(p32, cfg)
    low.set_prompt(prog.prompt)
    idx = list(range(len(records)))
    dec = cell.mix["decode"]
    sound = check.judge(check.readings(ref, records, idx, cfg, dec, seed),
                        cell.limits)
    ctrl = check.judge(check.readings(ref, records, idx, cfg, dec, seed,
                                      low=low), cell.limits)
    assert all(c["ok"] for c in sound.values()), sound
    assert not all(c["ok"] for c in ctrl.values()), ctrl


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path / "calib.jsonl"
    p = subprocess.run([sys.executable, str(ROOT / "perfbench" /
                                            "calibrate.py"),
                        "--workload", workload, "--seeds",
                        "2147483901,2147483902,2147483903",
                        "--out", str(out)], cwd=ROOT, capture_output=True,
                       text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-4000:]
    cell = harness.load_cell(ROOT, workload)
    for line in out.read_text().splitlines():
        row = json.loads(line)
        sound = check.judge(row["program"], cell.limits)
        ctrl = check.judge(row["control"], cell.limits)
        assert all(c["ok"] for c in sound.values()), row
        assert not all(c["ok"] for c in ctrl.values()), row
