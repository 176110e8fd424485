#!/usr/bin/env python3
"""A/B of the int64 relaxation kernels (csrc/relax64.cu and the graph
axis's csrc/shard_relax.cu) between checkouts, on one CUDA device.

    python3 ab_relax.py OTHER_CHECKOUT [OTHER_CHECKOUT ...] [--reps N]

Packs chip_smoke.py's querysparse2000 corpus into its eight int64
buckets once (this checkout's Python plane, each bucket with its hint)
and exports the giant corpus's giant contig as the graph axis pads it
for two shards, and solves each with this checkout's plain versions on
the card (the plain rounds of the giant contig take about a minute).
Then it times ``cuda_relax64.relax64`` on the buckets and
``cuda_shard_relax.shard_relax`` on the giant contig's two shards on one
card (the default route of each checkout) of each other checkout, this
checkout twice, and the others again in reverse order, each in its own
process that builds that checkout's kernels, on the same inputs (CUDA
events: the mean of ``--reps`` calls after a warm-up for the buckets,
one call after a warm-up for the giant).  Each process holds every
output to the plain one.  Prints the card's name and power limit and
one line per run and input; exits non-zero if a run fails or disagrees.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent

RUN = r"""
import glob, sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
from alignasm_tpu_torch.ops import cuda_relax64, cuda_shard_relax, _build
_build.load_library()
buckets, reps = sys.argv[2], int(sys.argv[3])
sys.path.insert(0, sys.argv[4])
from chip_smoke import cuda_ms, cuda_ms_once
KEYS = ("eu", "ev", "es", "ea", "enz", "etot", "erank", "evalid", "src",
        "dest", "order")
total = 0.0
for f in sorted(glob.glob(buckets + "/bucket*.npz")):
    z = np.load(f)
    dev = torch.device("cuda")
    args = [torch.from_numpy(z[k]).to(dev) for k in KEYS]
    V, ns = int(z["V"]), int(z["ns"])
    fn = lambda: cuda_relax64.relax64(*args[:10], V, ns, args[10])
    got = fn()
    for k, w in got.items():
        if not np.array_equal(w.cpu().numpy(), z["want_" + k]):
            sys.exit(f"{f}: relax64 {k} disagrees with plain")
    ms = cuda_ms(fn, reps)
    total += ms
    name = f.rsplit("/", 1)[1][:-4]
    print(f"{name} V={V} B={args[0].shape[0]}: relax64 {ms:.4f} ms",
          flush=True)
print(f"relax64 sum {total:.4f} ms", flush=True)
z = np.load(buckets + "/giant.npz")
cols = [z[f"c{j}"] for j in range(8)]
V, ns, dest, half = int(z["V"]), int(z["ns"]), int(z["dest"]), len(cols[0]) // 2
shards = [tuple(torch.from_numpy(c[k * half:(k + 1) * half]).cuda()
                for c in cols) for k in range(2)]
fn = lambda: cuda_shard_relax.shard_relax(shards, V, ns, dest)
fn()
ms, got = cuda_ms_once(fn)
for j, g in enumerate(got):
    if not np.array_equal(g.cpu().numpy(), z[f"want{j}"]):
        sys.exit(f"giant: shard_relax output {j} disagrees with plain")
print(f"giant V={V} {ns} sweeps, 2 shards on one card: shard_relax "
      f"{ms:.4f} ms", flush=True)
"""


def export_inputs(out: pathlib.Path) -> None:
    """This checkout's int64 buckets of querysparse2000 and the giant
    contig's padded edges, with the plain outputs, as .npz files in
    ``out``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from alignasm_tpu_torch.io.paf import read_paf
    from alignasm_tpu_torch.ops import relax
    from alignasm_tpu_torch.parallel import mesh as tmesh
    from alignasm_tpu_torch.runtime import scheduler as tsched

    cfg = chip_smoke.config()
    paf = chip_smoke.write_querysparse(chip_smoke.write_corpora(out)[
        "long2000"])
    stats = dict(singleton=0, oversize=0)
    _res, packed = tsched.pack_dataset(read_paf(str(paf)), cfg, stats)
    for i, bk in enumerate(tsched.python_buckets(packed, cfg)):
        *args, order = bk["args"]
        want = relax.solve_graph_batch_plain(
            *(torch.from_numpy(np.ascontiguousarray(a)).cuda()
              for a in args), V=bk["V"], n_sweeps=bk["n_sweeps"])
        keys = ("eu", "ev", "es", "ea", "enz", "etot", "erank", "evalid",
                "src", "dest")
        np.savez(out / f"bucket{i}.npz", **dict(zip(keys, args)),
                 order=order, V=bk["V"], ns=bk["n_sweeps"],
                 **{f"want_{k}": v.cpu().numpy() for k, v in want.items()})
    cols, V, ns, dest, *_rest = chip_smoke.giant_edges(
        chip_smoke.write_giant(out), cfg, 2)
    half = len(cols[0]) // 2
    want = tmesh.edge_sharded_sp_plain(
        [tuple(torch.from_numpy(c[k * half:(k + 1) * half]).cuda()
               for c in cols) for k in range(2)], V, ns, dest)
    np.savez(out / "giant.npz", **{f"c{j}": c for j, c in
                                       enumerate(cols)},
             **{f"want{j}": w.cpu().numpy() for j, w in enumerate(want)},
             V=V, ns=ns, dest=dest)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=pathlib.Path, nargs="+")
    ap.add_argument("--reps", type=int, default=50)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ab_relax: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        buckets = pathlib.Path(tmp)
        export_inputs(buckets)
        others = [("other", t) for t in a.other]
        order = others + [("this", ROOT)] * 2 + others[::-1]
        for tag, tree in order:
            print(f"--- {tag}: {tree}", flush=True)
            rc = subprocess.run([sys.executable, "-c", RUN,
                                 str(tree.resolve()), str(buckets),
                                 str(a.reps), str(ROOT)]).returncode
            if rc:
                print(f"ab_relax: the {tag} run failed ({rc})",
                      file=sys.stderr)
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
