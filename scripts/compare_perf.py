"""Set each experiment of ``repro_torch.launch.perf`` against its cell's
``baseline``, from the JSONL records the CLI appends.

    PYTHONPATH=src python -m repro_torch.launch.perf --cell A:S --exp baseline X Y --out out/A
    python3 scripts/compare_perf.py out/*.jsonl

For each cell, one line an experiment: ``equal`` where every field but
``wall_s`` is the baseline's; else the roofline terms, the peak and the NIC
GiB beside the baseline's, then each collective kind's GiB by the mesh axes
its groups span (``by_axis``) where it moved. An error record prints its
message.
"""

import json
import sys

GIB = 2 ** 30


def main(paths):
    cells = {}
    for path in paths:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                cells.setdefault((r["arch"], r["shape"]), {})[r["experiment"]] = r
    for (arch, shape), recs in cells.items():
        base = recs.get("baseline")
        print(f"{arch} x {shape}")
        for name, r in recs.items():
            if "error" in r:
                print(f"  {name:<28} {r['error']}")
                continue
            if base is None or name == "baseline":
                print(f"  {name:<28} compute {r['compute_ms']:.4f} memory {r['memory_ms']:.4f} "
                      f"collective {r['collective_ms']:.4f} ms, peak {r['peak_gb']:.4f} GiB, "
                      f"NIC {r['nic_gb']:.4f} GiB")
                continue
            if all(r[k] == base[k] for k in r if k not in ("experiment", "wall_s")):
                print(f"  {name:<28} equal")
                continue
            moved = []
            for kind, axes in sorted(r["by_axis"].items()):
                for ax, b in sorted(axes.items()):
                    b0 = base["by_axis"].get(kind, {}).get(ax, 0)
                    if b != b0:
                        moved.append(f"{kind} {ax} {b0 / GIB:.4f} -> {b / GIB:.4f}")
            print(f"  {name:<28} compute {base['compute_ms']:.4f} -> {r['compute_ms']:.4f}, "
                  f"memory {base['memory_ms']:.4f} -> {r['memory_ms']:.4f}, "
                  f"collective {base['collective_ms']:.4f} -> {r['collective_ms']:.4f} ms; "
                  f"peak {base['peak_gb']:.4f} -> {r['peak_gb']:.4f}, "
                  f"NIC {base['nic_gb']:.4f} -> {r['nic_gb']:.4f} GiB"
                  + ("; " + ", ".join(moved) if moved else ""))


if __name__ == "__main__":
    main(sys.argv[1:])
