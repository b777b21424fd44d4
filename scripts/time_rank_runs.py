"""Time every gloo rank run of the port's tests: a pytest plugin.

Each call of ``tests/_torch_ranks.run_ranks`` appends one JSON line to the
file ``RANK_TIMES`` names: the wall seconds of the call, its time limit, its
temporary directory's name (the fixture's, e.g. ``fsdp_tp3``), the calling
test file and line where the call is made in the test's own thread, and the
first entries of its inputs (a mesh's strategy and its models). Run the test
command as usual, with the plugin loaded in every worker:

    RANK_TIMES=rank_times.jsonl PYTHONPATH=scripts PYTEST_PLUGINS=time_rank_runs \\
        python -m pytest -q -p xdist -n 6 --dist loadfile

(``PYTHONPATH=src`` is prepended by the usual command.) Then each call's
share of its limit is ``seconds / timeout``.
"""

import json
import os
import pathlib
import sys
import time
import traceback

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tests"))
import _torch_ranks  # noqa: E402

_RUN_RANKS = _torch_ranks.run_ranks


def _what(inputs):
    """A mesh's strategy and its cases' names, where the inputs hold them."""
    if not isinstance(inputs, tuple) or not inputs or not isinstance(inputs[0], str):
        return None
    cases = next((x for x in inputs if isinstance(x, list)), [])
    return [inputs[0]] + [c[0] for c in cases if isinstance(c, tuple) and c]


def run_ranks(body, world, tmp_path, inputs=None, timeout=120, env=None):
    caller = next((f"{os.path.basename(f.filename)}:{f.lineno}"
                   for f in reversed(traceback.extract_stack())
                   if os.path.basename(f.filename).startswith("test_")), None)
    t0 = time.monotonic()
    ok = False
    try:
        out = _RUN_RANKS(body, world, tmp_path, inputs=inputs, timeout=timeout, env=env)
        ok = True
        return out
    finally:
        with open(os.environ["RANK_TIMES"], "a") as f:
            f.write(json.dumps({"seconds": round(time.monotonic() - t0, 1), "timeout": timeout,
                                "ok": ok, "tmp": pathlib.Path(tmp_path).name,
                                "caller": caller, "world": world,
                                "what": _what(inputs)}) + "\n")


_torch_ranks.run_ranks = run_ranks
