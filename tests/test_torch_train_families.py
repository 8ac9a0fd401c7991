"""The training launcher (``python -m repro_torch.launch.train``) on the
families beyond dense: hymba-1.5b (hybrid), falcon-mamba-7b (ssm) and
deepseek-moe-16b (moe), at ``--reduced`` width on the CPU.  AdLoCo runs
to its end with finite losses and parameters, prints one
``[train] ... stats probe`` line per round that ran the per-sample
probe (one pass off the card).  The families' losses and gradients are held
against the JAX package in ``test_torch_ssm`` and ``test_torch_moe``.
"""
import json

import numpy as np
import pytest

from repro_torch.launch import train as launch_train
from test_torch_lm import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b",
                                  "deepseek-moe-16b"])
def test_launcher_trains_family(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu",
            "--outer-steps", "2", "--inner-steps", "1", "--seq-len", "16",
            "--trainers", "1", "--workers", "2", "--stats-probe-size", "4",
            "--history-out", str(tmp_path / "hist.json")]
    assert launch_train.main(argv) == 0
    out = capsys.readouterr().out
    assert f"[train] arch={arch}-smoke" in out
    assert "[train] t=1 stats probe B=4: one pass" in out
    hist = json.loads((tmp_path / "hist.json").read_text())
    assert len(hist["loss"]) == 2 and all(np.isfinite(hist["loss"]))
    assert hist["stats_probe"][0] == [[4, 4, 1]]


def test_num_layers_cuts_depth_only():
    args = launch_train.parse_args(["--arch", "falcon-mamba-7b",
                                    "--num-layers", "8"])
    cfg, _ = launch_train.make_configs(args)
    full, _ = launch_train.make_configs(launch_train.parse_args(
        ["--arch", "falcon-mamba-7b"]))
    assert cfg.num_layers == 8 and full.num_layers == 64
    assert cfg.with_overrides(num_layers=64) == full
