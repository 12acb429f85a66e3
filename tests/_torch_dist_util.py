"""Run one script in N processes of one ``gloo`` process group, on the
CPU, for the port's multi-rank tests.

Each rank is its own interpreter, so no process group outlives its test
and none is made in the pytest worker.  The group meets through
``init_method="file://<tmp>"`` under the test's own ``tmp_path``, so
parallel workers never collide on a port.  Each rank runs with one
intra-op thread.
"""
import os
import pathlib
import subprocess
import sys
import textwrap
import time
import uuid

ROOT = pathlib.Path(__file__).resolve().parents[1]

PRELUDE = """\
import os
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo",
                        init_method="file://" + os.environ["INIT_FILE"],
                        rank=RANK, world_size=WORLD)
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(tmp_path: pathlib.Path, body: str, n: int, timeout: float,
              **env) -> str:
    """Run ``body`` on ranks 0..n-1 (``RANK``, ``WORLD``, ``dist`` and
    ``torch`` are defined) and return rank 0's stdout; fail with every
    rank's stderr if a rank fails or the run outlasts ``timeout``."""
    tag = uuid.uuid4().hex[:8]
    script = tmp_path / f"ranks_{tag}.py"
    script.write_text(PRELUDE + textwrap.dedent(body) + EPILOGUE)
    base = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "WORLD_SIZE": str(n), "OMP_NUM_THREADS": "1",
            "INIT_FILE": str(tmp_path / f"init_{tag}"),
            **{k: str(v) for k, v in env.items()}}
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env={**base, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise AssertionError(f"{n} ranks outlasted {timeout} s")
    bad = [(r, p.returncode, err[-3000:])
           for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, "\n".join(f"rank {r} exit {rc}:\n{err}"
                              for r, rc, err in bad)
    return outs[0][0]
