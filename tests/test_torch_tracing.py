"""The native route's stage spans (``runtime/tracing.py``) and the C++ host
plane's counter table (``native.trace`` / ``native.trace_read``) on the
CPU: nothing is counted or emitted without a profiler, every label and
every slot of the route shows under one, and the command line's
``--profile`` traces the native route.

Module-level imports are the port's only; the corpus is the port's
``synth_hard`` (contigs the device gates out) and twelve generated
contigs, some over the configuration's record caps, so that the route
reaches every slot of the table.
"""

import dataclasses
import json
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from alignasm_tpu_torch import cli, native
from alignasm_tpu_torch.config import DEFAULT_CONFIG
from alignasm_tpu_torch.runtime import tracing
from alignasm_tpu_torch.runtime.scheduler import solve_dataset_torch
from alignasm_tpu_torch.testing.synth import generate_paf

DATA = Path(__file__).resolve().parent / "data"
CFG = dataclasses.replace(DEFAULT_CONFIG, device_routing="always",
                          max_device_records=16, device_max_v=16)
STAGE_KEYS = ("pack_s", "pack_open_s", "bucket_s", "launch_s",
              "overlap_start_s", "sync_s", "cfinish_s", "finish_s",
              "overlap_join_s", "remaining_s", "write_s", "close_s",
              "total_s")


@pytest.fixture
def corpus(tmp_path):
    extra = generate_paf(n_contigs=12, seed=3, max_records_per_contig=40)
    paf = tmp_path / "in.paf"
    paf.write_text((DATA / "synth_hard.paf").read_text() + "".join(
        "x" + line + "\n" for line in extra.splitlines()))
    return paf


def _solve(paf, prefix):
    solve_dataset_torch(None, CFG, src_paths=(str(paf), None),
                        write_prefix=str(prefix), device="cpu")
    return solve_dataset_torch.last_stats


def _clear_table():
    native.drain_teardowns()
    native.trace_read()


def _zero(slots):
    return all(v == (0.0, 0) for v in slots.values())


def test_span_without_profiler_writes_its_key_and_no_event(monkeypatch):
    def no_event(label):
        raise AssertionError(f"record_function({label!r}) without a profiler")

    monkeypatch.setattr(tracing, "record_function", no_event)
    stats = {}
    with tracing.span(stats, "stage_s", tracing.PACK) as first:
        pass
    with tracing.span(stats, "stage_s", tracing.PACK) as second:
        pass
    assert stats == {"stage_s": first.seconds + second.seconds}
    with tracing.span(None, None, tracing.SOLVE):
        pass


def test_untraced_solve_counts_nothing(corpus, tmp_path):
    _clear_table()
    stats = _solve(corpus, tmp_path / "out")
    native.drain_teardowns()
    assert _zero(native.trace_read())
    assert set(STAGE_KEYS) <= set(stats)
    assert [k for k in stats if k.startswith("native_")] == ["native_direct"]


def test_profiled_pass_emits_every_label_and_counts_every_slot(corpus,
                                                                tmp_path):
    _clear_table()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):  # a teardown is counted in the next pass
            stats = _solve(corpus, tmp_path / "out")
            native.drain_teardowns()
    events = [e for e in prof.events() if e.name in tracing.LABELS]
    assert {e.name for e in events} == set(tracing.LABELS)
    for e in events:
        if e.name == tracing.SOLVE:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != tracing.SOLVE:
            parent = parent.cpu_parent
        assert parent is not None, e.name
    assert set(STAGE_KEYS) <= set(stats)
    left = native.trace_read()  # the second pass's teardown, at its end
    for name in left:
        assert stats[f"native_{name}_n"] > 0, name
        assert stats[f"native_{name}_s"] > 0, name
    assert left.pop("teardown")[1] == 1
    assert _zero(left)
    assert _zero(native.trace_read())


def test_cli_profile_traces_the_native_route(corpus, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setattr(cli, "DEFAULT_CONFIG", CFG)
    out = tmp_path / "prof"
    assert cli.run([str(corpus), "--profile", str(out), "--progress"],
                   device="cpu") == 0
    native.drain_teardowns()
    trace = json.loads((out / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {tracing.PACK, tracing.SOLVE} <= names
    printed = capsys.readouterr().out
    assert "native host plane, ms (count): " in printed
    assert " scan " in printed and " fallback " in printed
    for sfx in (".aln.paf", ".aln.alt.paf", ".aln.all.paf"):
        assert (tmp_path / f"in{sfx}").stat().st_size > 0
