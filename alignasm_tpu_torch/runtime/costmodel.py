"""Device-routing cost model of the port: a copy of
``alignasm_tpu/runtime/costmodel.py``.

With ``device_routing="auto"`` a bucket of contigs goes to the device
only when the model predicts that the device route (transport, kernel
and the device-assisted finish) beats the native solve of the same
contigs.  When no bucket can win (``any_possible_win()`` is False), the
engine runs the same fused native plane ``--engine native`` uses, so the
cuda engine is never slower than the native plane by more than the cost
of the decision.

Edits of the copy (everything else is the original, held to it by
tests/test_torch_routing.py):

(a) The operator override is ``$ALIGNASM_TORCH_COSTMODEL``; the JAX
    package's ``$ALIGNASM_TPU_COSTMODEL`` does not steer the port.
(b) ``CALIBRATION_PATH`` follows this file, so it names
    ``alignasm_tpu_torch/runtime/calibration.json``, which
    ``python -m alignasm_tpu_torch.runtime.devbench --calibrate`` writes
    on the card.  The JAX package's artifact, measured on a TPU host, is
    never read.
(c) Docstrings and comments.  The dataclass defaults are the JAX
    package's, kept so that an uncalibrated port decides as the JAX
    engine does.  They were measured for the TPU host and are not this
    card's numbers: the H100's numbers live in the artifact and in
    PERF.md.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class DeviceCostModel:
    # Every default below is the JAX package's (alignasm_tpu's cost
    # model, measured for its TPU host); the port's calibration artifact
    # replaces them with the card's own readings.

    # --- transport ---
    # fixed round trip per dispatch/transfer op
    dispatch_rtt_s: float = 0.026
    # host->device bandwidth of the sparse wire
    h2d_bytes_per_s: float = 50e6
    # device->host bandwidth of the gate rows
    d2h_bytes_per_s: float = 14e6

    # --- host plane: the full native solve, all cores ---
    solve_s_per_record: float = 6.1e-7
    solve_s_per_contig_min: float = 2e-6

    # --- the Amdahl ratio ---
    # the device route's host-side cost with the DP removed (wire export
    # + the device-assisted finish) over the full native solve of the
    # same contigs, identical cold-graph state; predict_device_s charges
    # it as the route's whole host cost.  The device can only win when
    # this ratio is < 1 (the finish must be cheaper than the work it
    # replaces by more than the transport).
    finish_vs_solve: float = 1.07

    # --- device compute ---
    # marginal per-contig kernel cost at V <= 64, B large
    device_s_per_contig: float = 1.7e-6
    # per-vertex cost of the big-V blocked solve
    device_s_per_step: float = 2e-6

    def any_possible_win(self) -> bool:
        """Can ANY bucket on this hardware profile route profitably?

        The device route replaces the full native solve of a bucket
        with export + transport + kernel + the device-assisted finish,
        i.e. costs at least ``finish_vs_solve * t_native + rtt``.  A
        win therefore requires finish_vs_solve < 1 (the transport adds
        a strictly positive floor on top).  With the measured ratio
        >= 1 the answer is corpus-independent: route nothing, run the
        fused native plane.
        """
        return self.finish_vs_solve < 0.999

    def predict_native_s(self, sum_records: int, n_contigs: int) -> float:
        """Full native solve of a contig set (all-core host plane)."""
        return max(self.solve_s_per_record * sum_records,
                   self.solve_s_per_contig_min * n_contigs)

    def predict_device_s(self, n_contigs: int, V: int, wire_bytes: int,
                         row_bytes: int, sum_records: int) -> float:
        """Device route of one bucket: transport + kernel + finish."""
        kernel = max(self.device_s_per_contig * n_contigs,
                     self.device_s_per_step * V)
        finish = self.finish_vs_solve * self.predict_native_s(
            sum_records, n_contigs)
        return (self.dispatch_rtt_s
                + wire_bytes / self.h2d_bytes_per_s
                + row_bytes / self.d2h_bytes_per_s
                + kernel + finish)

    def bucket_profitable(self, n_contigs: int, V: int, wire_bytes: int,
                          row_bytes: int, sum_records: int) -> bool:
        return (self.predict_device_s(n_contigs, V, wire_bytes, row_bytes,
                                      sum_records)
                < self.predict_native_s(sum_records, n_contigs))

    def summary(self) -> dict:
        return {
            "finish_vs_solve": self.finish_vs_solve,
            "dispatch_rtt_s": self.dispatch_rtt_s,
            "h2d_MB_per_s": round(self.h2d_bytes_per_s / 1e6, 1),
            "d2h_MB_per_s": round(self.d2h_bytes_per_s / 1e6, 1),
            "any_possible_win": self.any_possible_win(),
        }


# the card's calibration artifact, written by ``python -m
# alignasm_tpu_torch.runtime.devbench --calibrate``: the gate's constants
# trace to a dated measurement, with the defaults as the fallback when
# it is stale or absent
CALIBRATION_PATH = os.path.join(os.path.dirname(__file__),
                                "calibration.json")


def _meta_of(raw: dict) -> dict:
    """The _meta block, tolerating corruption: any non-dict value (a
    torn artifact must NEVER steer or crash the gate) reads as absent."""
    meta = raw.get("_meta")
    return meta if isinstance(meta, dict) else {}


def _parse_model(raw: dict, source: str, path: str):
    meta = _meta_of(raw)
    fields = {f.name for f in dataclasses.fields(DeviceCostModel)}
    unknown = set(raw) - fields - {"_meta"}
    if unknown:
        raise ValueError(f"unknown cost-model fields: {sorted(unknown)}")
    model = DeviceCostModel(**{k: float(v) for k, v in raw.items()
                               if k != "_meta"})
    prov = {"source": source, "path": path}
    for k in ("date", "stale_after", "device_kind", "method"):
        if k in meta:
            prov[k] = meta[k]
    if "date" in meta:
        import datetime

        try:
            age = (datetime.date.today()
                   - datetime.date.fromisoformat(meta["date"])).days
            prov["age_days"] = age
        except (ValueError, TypeError):
            pass
    return model, prov


def _is_stale(raw: dict) -> str | None:
    """A calibration artifact self-declares its shelf life via
    ``_meta.stale_after`` (ISO date).  Returns the reason string when
    the artifact should NOT be trusted implicitly, else None."""
    import datetime

    meta = _meta_of(raw)
    stale_after = meta.get("stale_after")
    if not stale_after:
        return "no _meta.stale_after"
    try:
        limit = datetime.date.fromisoformat(stale_after)
    except (ValueError, TypeError):
        return f"unparsable stale_after {stale_after!r}"
    if datetime.date.today() > limit:
        return f"stale since {stale_after}"
    return None


def load_model_info() -> tuple[DeviceCostModel, dict]:
    """(model, provenance).  Resolution order:

    1. ``$ALIGNASM_TORCH_COSTMODEL`` — explicit operator override,
       loaded unconditionally (unknown fields still raise);
    2. the card's calibration artifact (``CALIBRATION_PATH``, written by
       ``devbench --calibrate``) when present AND fresh per its own
       ``_meta.stale_after``;
    3. the dataclass defaults (the JAX package's).

    The provenance dict is recorded in ``solve_dataset_torch.last_stats``
    so every routed run states which measurement its gate ran on."""
    path = os.environ.get("ALIGNASM_TORCH_COSTMODEL")
    if path:
        with open(path) as fh:
            raw = json.load(fh)
        return _parse_model(raw, "env", path)
    try:
        with open(CALIBRATION_PATH) as fh:
            raw = json.load(fh)
        if not isinstance(raw, dict):
            raise ValueError("calibration root is not an object")
    except (OSError, ValueError) as exc:
        return DeviceCostModel(), {
            "source": "defaults",
            "note": f"no calibration artifact ({exc.__class__.__name__})"}
    stale = _is_stale(raw)
    if stale:
        return DeviceCostModel(), {
            "source": "defaults",
            "note": f"calibration artifact ignored: {stale}"}
    try:
        return _parse_model(raw, "artifact", CALIBRATION_PATH)
    except (ValueError, TypeError) as exc:
        return DeviceCostModel(), {
            "source": "defaults",
            "note": f"calibration artifact invalid: {exc}"}


def load_model() -> DeviceCostModel:
    """The card's calibration, overridable per deployment via a JSON
    file at ``$ALIGNASM_TORCH_COSTMODEL`` (any subset of the dataclass
    fields; see load_model_info for the full resolution order)."""
    return load_model_info()[0]
