#!/usr/bin/env python3
"""K5 (cull) and K3 (leaf update) of another checkout against this one, on
one card, in eight turns (other, this, this, other, twice).  Run from this
checkout's root:

    python3 kernel_ab.py OTHER [--json OUT.json]

OTHER is the root of another checkout of the repository (a `git archive`
of the parent commit, say).  Each turn is one process with that turn's
checkout first on sys.path, so it imports that checkout's port, whose
ops/_ext.py builds that checkout's csrc/ into its own _build/.  The inputs
and the readings are this checkout's (chip_smoke.ab_turn, and the port's
testing module put in place of the other's): K5 in the timed
setups of chip_smoke's phase 6a, K3 at 16,000,017 rows, level 8, each
held bit-equal to its plain version first; for each, one call, 20 calls
queued back to back, torch.profiler's device time and the least work.
Prints one line a reading, then each setup's medians over the turns and
their ratio; --json PATH keeps every row.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# One turn: the checkout in argv[1] first on sys.path; this checkout's
# testing module (argv[2]) in place of the port's, and its chip_smoke
# (argv[3]), loaded from their files; the rows as the last line of output.
_TURN = """
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
import point_cloud_viewer_tpu_torch as P
assert P.__file__.startswith(sys.argv[1]), P.__file__
def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
load("point_cloud_viewer_tpu_torch.testing", sys.argv[2])
print(json.dumps(load("chip_smoke_ab", sys.argv[3]).ab_turn()))
"""


def turn(checkout: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", _TURN, checkout,
         os.path.join(ROOT, "point_cloud_viewer_tpu_torch", "testing.py"),
         os.path.join(ROOT, "chip_smoke.py")],
        cwd=checkout, check=True, stdout=subprocess.PIPE, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--json", help="write every row here")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from point_cloud_viewer_tpu_torch.ops import hbm_probe

    card = hbm_probe.card_label(torch.device("cuda"))
    rate = hbm_probe.published_peak_gbps(torch.cuda.get_device_name(0))
    roots = {"other": os.path.abspath(args.other), "this": ROOT}
    rows = []
    for i, tag in enumerate(["other", "this", "this", "other"] * 2):
        for r in turn(roots[tag]):
            r.update(tree=tag, turn=i)
            rows.append(r)
            dms = r["device_ms"]
            print(f"[{card}] {r['kernel']} {tag} (turn {i}) {r['setup']}: "
                  f"one call {r['ms']:.4f} ms, 20 queued back to back "
                  f"{r['train_ms']:.4f} ms a call, device "
                  + ("not measured" if dms is None else f"{dms:.4f} ms"),
                  flush=True)
    for kernel, setup in dict.fromkeys((r["kernel"], r["setup"])
                                       for r in rows):
        mine = [r for r in rows
                if (r["kernel"], r["setup"]) == (kernel, setup)]
        bound = max(mine[0]["bytes"] / (rate * 1e9),
                    mine[0]["ops"] / chip_smoke.FP32_PEAK_OPS) * 1e3
        med = {}
        for tag in roots:
            for key in ("device_ms", "train_ms"):
                vals = [r[key] for r in mine
                        if r["tree"] == tag and r[key] is not None]
                med[tag, key] = statistics.median(vals) if vals else None
        text = []
        for key in ("device_ms", "train_ms"):
            o, t = med["other", key], med["this", key]
            if o is None or t is None:
                text.append(f"{key} not measured in every turn of a tree")
                continue
            text.append(f"{key} other {o:.4f} / this {t:.4f} = {o / t:.2f}x; "
                        f"this / bound {t / bound:.2f}")
        print(f"[{card}] {kernel} {setup}, medians over the turns: bound "
              f"{bound:.4f} ms ({mine[0]['bytes']} B, {mine[0]['ops']} f32 "
              f"ops; memory rate {rate} GB/s); " + "; ".join(text),
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "other": roots["other"], "rows": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
