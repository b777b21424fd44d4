"""Run a piece of code on N gloo ranks, each its own Python process.

Used by the port's multi-rank CPU tests. Every rank runs ``body`` inside
``repro_torch.launch.mesh.process_group("cpu", rank, world, store)``, with
``rank``, ``world`` and ``inputs`` (the caller's object, pickled) bound and
one torch thread; whatever it assigns to ``result`` comes back, one entry a
rank. The ranks meet through a
``file://`` store under the caller's temporary directory (several test
workers run at once, so no fixed TCP port), and every process is killed
when the time limit passes.
"""

import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import pickle, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch.mesh import process_group
rank, world = int(sys.argv[1]), int(sys.argv[2])
with open(sys.argv[5], "rb") as f:
    inputs = pickle.load(f)
result = None
with process_group("cpu", rank, world, sys.argv[3]):
{body}
with open(sys.argv[4], "wb") as f:
    pickle.dump(result, f)
"""


def run_ranks(body, world, tmp_path, inputs=None, timeout=120, env=None):
    """``body`` on ``world`` ranks; returns each rank's ``result``."""
    tmp_path = pathlib.Path(tempfile.mkdtemp(dir=tmp_path))  # a fresh store each call
    script = tmp_path / "ranks.py"
    script.write_text(_PRELUDE.format(body=textwrap.indent(textwrap.dedent(body), "    ")))
    store = tmp_path / "store"
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    full_env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1",
                **(env or {})}
    outs = [tmp_path / f"rank{r}.pkl" for r in range(world)]
    logs = [tmp_path / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:  # a file: a full pipe would stall the rank
            procs.append(subprocess.Popen(
                [sys.executable, str(script), str(r), str(world), str(store), str(outs[r]),
                 str(tmp_path / "inputs.pkl")],
                env=full_env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        log = logs[r].read_text()[-3000:]
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    results = []
    for out in outs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results
