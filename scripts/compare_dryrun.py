"""Compare two sets of the port's dry-run records, cell by cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch A --shape S --out before/A
    ... (the same on the other tree, into after/A)
    python3 scripts/compare_dryrun.py BEFORE.jsonl [...] -- AFTER.jsonl [...]

For each (arch, shape, mesh, strategy) in both sets, one row: TFLOP a rank,
NIC GiB, peak GiB with its activations and temporaries, ``useful``, the
roofline's compute / memory / collective ms, and the collective bytes a
ring moves, in GiB. The dry run files an all-reduce at its operand and an
all-gather or reduce-scatter at the whole tensor (the reference's
convention), so an all-reduce of X counts X and the all-gather and
reduce-scatter pair that replaces it counts 2X; a ring moves 2(M-1)/M of
X for the all-reduce and (M-1)/M for each of the pair, so "ring" here is
all-gather + reduce-scatter + 2 x all-reduce + all-to-all bytes (the
(M-1)/M factor left out: every group of a 16 x 16 mesh has M = 16).
"""

from __future__ import annotations

import json
import sys

GIB = 2 ** 30


def load(paths):
    out = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") == "ok":
                    out[(r["arch"], r["shape"], r["mesh"], r["strategy"])] = r
    return out


def row(r):
    kind = r["collectives"]["by_kind"]
    ring = sum(b * (2 if k == "all-reduce" else 1) for k, b in kind.items())
    mem, ro = r["memory_per_rank_gb"], r["roofline"]
    return {"tflop": r["cost"]["flops"] / 1e12, "nic_gib": r["collectives"]["nic_bytes"] / GIB,
            "ring_gib": ring / GIB, "peak_gib": r["peak_memory_gb"],
            "activations_gib": mem["activations"], "temporaries_gib": mem["temporaries"],
            "useful": ro["useful_ratio"], "compute_ms": ro["compute_ms"],
            "memory_ms": ro["memory_ms"], "collective_ms": ro["collective_ms"],
            "by_kind_gib": {k: b / GIB for k, b in kind.items()}}


def main(argv):
    if "--" not in argv:
        sys.exit(__doc__)
    cut = argv.index("--")
    before, after = load(argv[:cut]), load(argv[cut + 1:])
    for key in sorted(before.keys() & after.keys()):
        a, b = row(before[key]), row(after[key])
        print(json.dumps({"cell": " ".join(key), "before": a, "after": b,
                          "ratio": {k: b[k] / a[k] for k in a
                                    if isinstance(a[k], float) and a[k]}}))
        print(f"| {key[0]} {key[1]} | {a['tflop']:.1f} → {b['tflop']:.1f} | "
              f"{a['nic_gib']:.1f} → {b['nic_gib']:.1f} | {a['ring_gib']:.1f} → "
              f"{b['ring_gib']:.1f} | {a['peak_gib']:.1f} → {b['peak_gib']:.1f} | "
              f"{a['activations_gib']:.1f} → {b['activations_gib']:.1f} | "
              f"{a['useful']:.3f} → {b['useful']:.3f} | {a['compute_ms']:.0f} / "
              f"{a['memory_ms']:.0f} / {a['collective_ms']:.0f} → {b['compute_ms']:.0f} / "
              f"{b['memory_ms']:.0f} / {b['collective_ms']:.0f} |")


if __name__ == "__main__":
    main(sys.argv[1:])
