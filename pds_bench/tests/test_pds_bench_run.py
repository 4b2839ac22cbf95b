"""The entry point refuses to run where it cannot measure: without the
cell's cards, and in a directory that holds only the benchmark's files."""

import shutil
import subprocess
import sys

import pytest

from pds_bench import registry, run

ARGS = ["--workload", "ft3d-serve-b1", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.PACKAGE, tmp_path / "pds_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "-m", "pds_bench.run", *ARGS],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin",
                                            "HOME": str(tmp_path)})
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.parametrize("workload", ["ft3d-serve-b1", "ft3d-train-b1",
                                      "kitti-serve-b4", "kitti-train-b4"])
def test_unknown_arguments_are_refused(workload):
    with pytest.raises(SystemExit):
        run.main(["--workload", workload, "--seed", "1", "--seconds", "1",
                  "--trace", "2"])
