"""Small traffic for the CPU tests: each cell's own traffic file, cut to a
size a test holds."""

from benchmark import run

# the alt PAF (-a) of a deployment that re-aligns contig fragments: about
# a third of the contigs, one to three groups each of one to three records
ALT = {"contig_share": 0.3, "groups": [1, 3], "records_per_group": [1, 3],
       "fragment": [1000, 100000], "pass_share": 0.6, "near_share": 0.7}


def small_traffic(workload: str) -> dict:
    """The cell's traffic with 50 contigs, or three chains of 60-300
    segments over 2 % of their chromosomes."""
    tr = run.load_cell(workload)["traffic"]
    if tr["family"] == "assembly":
        return dict(tr, contigs=50, warm_passes=1)
    return dict(tr, segments=[60, 150, 300], span_share=0.02, warm_passes=1)


def alt_traffic(workload: str) -> dict:
    """``small_traffic`` with the alt block ``ALT``."""
    return dict(small_traffic(workload), alt=ALT)


def config(workload: str) -> dict:
    """The cell's configuration."""
    return run.load_cell(workload)["config"]


def cpu_run(workload, tmp_path, seed=2**31 + 5, seconds=1.0, trace=False,
            traffic=None):
    return run.run_cell(workload, seed, seconds, trace, device="cpu",
                        require_card=False, cache=tmp_path / "cache",
                        traffic=traffic or small_traffic(workload), workers=2,
                        log=lambda _msg: None)
