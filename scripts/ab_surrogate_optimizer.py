"""Surrogate training time with another checkout's AdamW against this one's.

    python3 scripts/ab_surrogate_optimizer.py OTHER_CHECKOUT [--steps 300]

Trains the dispatcher's surrogate (``repro_torch.core.train_surrogate``, the
quickstart's 250 H100 samples) on the card four times in turns: with the
AdamW of ``OTHER_CHECKOUT/src/repro_torch/train/optimizer.py`` (an older
commit unpacked with ``git archive``), with this checkout's, with this
checkout's, with the other's. Prints ms per step and the final loss of each
run: equal losses show that the two updates do the same arithmetic.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.core as core  # noqa: E402
from repro_torch.core import training  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402


def load_other(checkout: Path):
    path = checkout / "src" / "repro_torch" / "train" / "optimizer.py"
    spec = importlib.util.spec_from_file_location("other_optimizer", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up here
    spec.loader.exec_module(module)
    return module


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    other = load_other(args.other)
    cl = core.h100_cluster()
    sim = core.BandwidthSimulator(cl)
    tables = core.IntraHostTables(cl, sim)
    train, _ = core.make_train_test_split(sim, 250, seed=0)
    for side, module in (("other", other), ("this", optimizer), ("this", optimizer),
                         ("other", other)):
        training.adamw = module.adamw
        _, info = core.train_surrogate(cl, tables, train, core.TrainConfig(steps=args.steps))
        print(f"{side}: {info['train_seconds'] / args.steps * 1e3} ms a step, "
              f"final loss {info['final_loss']}", flush=True)


if __name__ == "__main__":
    main()
