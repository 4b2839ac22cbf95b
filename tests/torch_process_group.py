"""Runs a scenario of a port test file in a group of processes joined over
gloo on the CPU, as ``torchrun`` would: ``python -m <module> <scenario>
<output> ...`` with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set. The group is killed at its time
limit, so that a hung collective fails one test instead of the suite."""

import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


class Group:
    """``scenario`` of ``module`` started in ``size`` processes; the
    caller may work while they run, then :meth:`wait` returns each one's
    output file."""

    def __init__(self, folder, module: str, scenario: str, size: int,
                 timeout_s: float, *arguments: str):
        port = str(free_port())
        self.scenario, self.timeout_s = scenario, timeout_s
        self.outputs, self.processes, self.logs = [], [], []
        for rank in range(size):
            self.outputs.append(str(folder / f"{scenario}_{rank}.out"))
            self.logs.append(open(folder / f"{scenario}_{rank}.log", "w+"))
            environment = dict(os.environ, RANK=str(rank),
                               WORLD_SIZE=str(size), LOCAL_RANK=str(rank),
                               MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                               OMP_NUM_THREADS="1")
            self.processes.append(subprocess.Popen(
                [sys.executable, "-m", module, scenario, self.outputs[-1],
                 *arguments], cwd=ROOT, env=environment,
                stdout=self.logs[-1], stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + timeout_s

    def wait(self) -> list[str]:
        """Each process's output file; fails unless every process exited
        0 within the time limit."""
        try:
            for process in self.processes:
                process.wait(timeout=max(0.1,
                                         self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for process in self.processes:
                if process.poll() is None:
                    process.kill()
                    process.wait()
        texts = []
        for log in self.logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        for rank, process in enumerate(self.processes):
            assert process.returncode == 0, (
                f"process {rank} of {self.scenario}: exit "
                f"{process.returncode} (killed after {self.timeout_s} s if "
                "negative)\n" + texts[rank][-4000:])
        return self.outputs
