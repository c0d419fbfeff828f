"""One torch thread for every test process, and for every child it starts.

Six xdist workers share eight cores, and an OpenMP pool the size of the
machine in each of them starves the others. The settings sit at module level
here: every xdist worker imports every test module while it collects, before
any test runs, so they hold in every worker, and children started later
inherit the environment.
"""
import os
import subprocess
import sys

import pytest
import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)


@pytest.mark.parametrize("where", ["test_process", "child_process"])
def test_one_torch_thread(where):
    if where == "test_process":
        n = torch.get_num_threads()
    else:  # the child inherits this process's environment
        r = subprocess.run(
            [sys.executable, "-c",
             "import torch; print(torch.get_num_threads())"],
            capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-3000:]
        n = int(r.stdout)
    assert n == 1
