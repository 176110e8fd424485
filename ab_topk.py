#!/usr/bin/env python3
"""A/B of the top-K walk kernel (csrc/topk.cu) between checkouts, on one
CUDA device.

    python3 ab_topk.py OTHER_CHECKOUT [OTHER_CHECKOUT ...] [--reps N]

Packs chip_smoke.py's long2000 corpus with this checkout's Python plane
and groups its contigs into chip_smoke.py's 12 top-K batches (V 8-512,
at most 256 contigs a batch, K = 16, n_sweeps the batch's largest vertex
count), and computes each batch's plain output on the card once.  Then
it times ``cuda_topk.topk_walks_batch`` on the batches with each other
checkout, this checkout twice, and the others again in reverse order,
each in its own process that builds that checkout's kernels (CUDA
events: the mean of ``--reps`` calls after a warm-up).  Each process
prints the card's name and power limit and holds every output to the
plain one; every run must count the same sweeps on every batch.  Prints
one line per run and batch and each run's sum; exits non-zero if a run
fails, disagrees or counts other sweeps.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent

RUN = r"""
import glob, json, subprocess, sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
from alignasm_tpu_torch.ops import cuda_topk, _build
_build.load_library()
batches, reps = sys.argv[2], int(sys.argv[3])
sys.path.insert(0, sys.argv[4])
from chip_smoke import TOPK_K, cuda_ms
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip(), flush=True)
total, ran = 0.0, []
for f in sorted(glob.glob(batches + "/batch*.npz")):
    z = np.load(f)
    wk1 = torch.from_numpy(z["wk1"]).cuda()
    dest = torch.from_numpy(z["dest"]).cuda()
    V, ns = int(z["V"]), int(z["ns"])
    sweeps = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = cuda_topk.topk_walks_batch(wk1, dest, V, TOPK_K, ns, sweeps)
    if not np.array_equal(got.cpu().numpy(), z["want"]):
        sys.exit(f"{f}: topk disagrees with plain")
    ms = cuda_ms(lambda: cuda_topk.topk_walks_batch(wk1, dest, V, TOPK_K,
                                                    ns), reps)
    total += ms
    ran.append(int(sweeps))
    name = f.rsplit("/", 1)[1][:-4]
    print(f"{name} V={V} B={wk1.shape[0]} n_sweeps={ns}: topk {ms:.4f} ms, "
          f"sweeps {ran[-1]}", flush=True)
print(f"topk sum {total:.4f} ms over {len(ran)} batches, sweeps {sum(ran)}",
      flush=True)
print(json.dumps({"ms": total, "sweeps": ran}), flush=True)
"""


def export_batches(out: pathlib.Path) -> None:
    """This checkout's long2000 top-K batches with their plain outputs, as
    .npz files in ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops import topk
    from alignasm_tpu_torch.runtime import scheduler as tsched

    paf = chip_smoke.write_corpora(out)["long2000"]
    stats = dict(singleton=0, oversize=0)
    _res, packed = tsched.pack_dataset(read_paf(str(paf)), chip_smoke.config(),
                                       stats)
    items = [(pg.g, pg) for _i, pg in packed]
    batches = chip_smoke.topk_batches(
        items, lambda gs: max(g.n_vertices for g in gs))
    for i, (V, chunk, ns) in enumerate(batches):
        wk1 = np.stack([topk.pack_edge_keys(pg, V) for _g, pg in chunk])
        dest = np.array([g.dest for g, _pg in chunk], np.int32)
        want = topk.topk_walks_batch_plain(torch.from_numpy(wk1).cuda(),
                                           torch.from_numpy(dest).cuda(), V,
                                           chip_smoke.TOPK_K, ns)
        np.savez(out / f"batch{i:02d}.npz", wk1=wk1, dest=dest, V=V, ns=ns,
                 want=want.cpu().numpy())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_topk: needs a CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        batches = pathlib.Path(tmp)
        export_batches(batches)
        others = [("other", t) for t in a.other]
        order = others + [("this", ROOT)] * 2 + others[::-1]
        counted = None
        for tag, tree in order:
            print(f"--- {tag}: {tree}", flush=True)
            p = subprocess.run([sys.executable, "-c", RUN,
                                str(tree.resolve()), str(batches),
                                str(a.reps), str(ROOT)],
                               stdout=subprocess.PIPE, text=True)
            print(p.stdout, end="", flush=True)
            if p.returncode:
                print(f"ab_topk: the {tag} run failed ({p.returncode})",
                      file=sys.stderr)
                return 1
            sweeps = json.loads(p.stdout.strip().splitlines()[-1])["sweeps"]
            if counted is not None and sweeps != counted:
                print(f"ab_topk: the {tag} run counted sweeps {sweeps}, "
                      f"another {counted}", file=sys.stderr)
                return 1
            counted = sweeps
    return 0


if __name__ == "__main__":
    sys.exit(main())
