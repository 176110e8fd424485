#!/usr/bin/env python3
"""A/B of the 16-bit wire densify kernel between checkouts, on one CUDA
device.

    python3 ab_densify.py OTHER_CHECKOUT [OTHER_CHECKOUT ...] [--reps N]
                          [--profile]

Exports the 16-bit wire buckets of chip_smoke.py's karyotype10k and
long2000 corpora once (this checkout's exporter), then times
``alignasm_tpu_torch.ops.cuda_densify.densify_wire16`` of each other
checkout, this checkout twice, and the others again in reverse order,
each in its own process that builds that checkout's kernels, on the same
wires (CUDA events, the mean of ``--reps`` calls after a warm-up), with
a bare ``torch.full`` of the same slab buffer beside each: the card's
write floor.  ``--profile`` adds each launch's mean device time
(torch.profiler).  Each process also holds its slabs to this checkout's
plain ``densify_wire16``.  Prints the card's name and power limit and
one line per run and bucket; exits non-zero if a run fails or
disagrees.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent

RUN = r"""
import sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
from alignasm_tpu_torch.ops import cuda_densify, _build
_build.load_library()
wires, reps, prof = sys.argv[2], int(sys.argv[3]), sys.argv[5] == "1"
sys.path.insert(0, sys.argv[4])
from chip_smoke import cuda_ms
from torch.profiler import ProfilerActivity, profile
for f in sorted(__import__("glob").glob(wires + "/*.npz")):
    z = np.load(f)
    dev = torch.device("cuda")
    args = [torch.from_numpy(z[k]).to(dev) for k in ("d", "v", "t", "s")]
    n_real, B, V = int(z["n"]), int(z["B"]), int(z["V"])
    want = torch.from_numpy(z["want"]).to(dev)
    fn = lambda: cuda_densify.densify_wire16(*args[:4], n_real, B, V)
    if not torch.equal(fn(), want):
        sys.exit(f"{f}: densify_wire16 disagrees with plain")
    ms = cuda_ms(fn, reps)
    fill = cuda_ms(lambda: torch.full((B * V * (V + 1),), 2**30,
                                      dtype=torch.int32, device=dev), reps)
    name = f.rsplit("/", 1)[1][:-4]
    parts = ""
    if prof:
        with profile(activities=[ProfilerActivity.CUDA]) as pr:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        parts = "; launches (us): " + ", ".join(
            f"{e.key.split('(')[0].split('::')[-1]} "
            f"{e.self_device_time_total / e.count:.1f}"
            for e in pr.key_averages() if e.self_device_time_total > 0)
    print(f"{name} V={V} padB={B}: densify_wire16 {ms:.4f} ms, "
          f"bare fill {fill:.4f} ms{parts}", flush=True)
"""


def export_wires(out: pathlib.Path) -> None:
    """This checkout's wire16 buckets of karyotype10k and long2000, with
    the plain slabs, as .npz files in ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from alignasm_tpu_torch.ops import dense

    cfg = chip_smoke.config()
    paths = chip_smoke.write_corpora(out)
    for name in ("karyotype10k", "long2000"):
        for V, _realB, padB, kind, args in chip_smoke.buckets_of(
                paths[name], cfg, torch.device("cuda")):
            if kind != "wire16":
                continue
            want = dense.densify_wire16(*args, padB, V)
            np.savez(out / f"{name}_V{V}.npz",
                     **{k: a.cpu().numpy() for k, a in zip("dvts", args)},
                     n=args[4], B=padB, V=V, want=want.cpu().numpy())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, nargs="+")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_densify: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        wires = pathlib.Path(tmp)
        export_wires(wires)
        others = [("other", t) for t in a.other]
        order = others + [("this", ROOT)] * 2 + others[::-1]
        for tag, tree in order:
            print(f"--- {tag}: {tree}", flush=True)
            rc = subprocess.run([sys.executable, "-c", RUN,
                                 str(tree.resolve()), str(wires),
                                 str(a.reps), str(ROOT),
                                 str(int(a.profile))]).returncode
            if rc:
                print(f"ab_densify: the {tag} run failed ({rc})",
                      file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
