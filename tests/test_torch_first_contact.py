"""The port's one-command bring-up (``rocnrdma_tpu_torch/first_contact.py``)
end to end on the CPU: the reference's seven steps in its order, all ok,
exit 0, the calibration artifact under ``--outdir`` (the package's
``results/`` untouched), and the measured table merged over the model's
table for this device with ``mixed`` provenance."""

import json
import os

from rocnrdma_tpu_torch import first_contact, hw
from rocnrdma_tpu_torch import metrics as M

STEPS = ["calibrate_chip", "dryrun", "cli_smoke", "measured_sweep",
         "alltoall_scored", "table_merge", "align_steps"]


def _snapshot(d):
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in sorted(os.listdir(d))}


def test_first_contact_end_to_end_on_the_cpu(tmp_path):
    from rocnrdma_tpu import first_contact as RF
    import inspect
    ref_steps = [s for s in STEPS if f'"{s}"' in inspect.getsource(RF)]
    assert ref_steps == STEPS  # the reference's step names, in its order

    before = _snapshot(hw.RESULTS_DIR)
    outdir = tmp_path / "fc"
    rc = first_contact.main([
        "--outdir", str(outdir), "--platform", "cpu", "--fake-devices", "8",
        "--sizes", "4K,64K", "--smoke-size", "64K",
        "--verbs", "allreduce,allgather", "--align-algo", "dtree"])
    report = [json.loads(ln) for ln in (outdir / "report.jsonl").read_text().splitlines()]
    assert [r["step"] for r in report] == STEPS
    assert all(r["ok"] for r in report), [r for r in report if not r["ok"]]
    assert rc == 0
    steps = {r["step"]: r for r in report}

    # the calibration lands in --outdir; the package's results/ is untouched
    cal_path = steps["calibrate_chip"]["artifact"]
    assert cal_path.startswith(str(outdir))
    cal = json.load(open(cal_path))
    assert "2" in cal["fold_ladder"] and cal["dispatch_alpha_s"] > 0
    assert _snapshot(hw.RESULTS_DIR) == before

    assert "OK" in steps["dryrun"]["stdout"]
    smoke = [json.loads(ln) for ln in (outdir / "cli_smoke.jsonl").read_text().splitlines()]
    assert {r["collective"] for r in smoke} >= {"allreduce", "alltoall", "allgather"}
    base = [json.loads(ln) for ln in
            (outdir / "first_contact_baseline.jsonl").read_text().splitlines()]
    assert base and all(r["s_per_call"] > 0 for r in base)
    for r in base:  # busbw at 3 decimals: a slow 4 KiB call on a loaded host rounds to 0
        assert r["busbw_GBps"] == round(M.busbw_GBps(r["collective"], 8, r["size_bytes"],
                                                     r["s_per_call"]), 3)
    assert {r["collective"] for r in base} == {"allreduce", "allgather"}
    a2a = json.load(open(outdir / "alltoall_algbw.json"))
    assert a2a["metric"] == "alltoall_algbw_GBps_per_chip" and a2a["value"] > 0
    assert a2a["spread"][0] <= a2a["value"] <= a2a["spread"][1]

    # the model table under the sweep is this device's, never a TPU table
    model = json.load(open(outdir / "tuning_model.json"))["_meta"]
    assert model["device_kind"] == "cpu" and "model-derived" in model["provenance"]
    merged = json.load(open(outdir / "tuning_merged.json"))
    assert merged["_meta"]["provenance"].startswith("mixed")
    measured = json.load(open(outdir / "tuning_measured.json"))
    for key in measured:
        if key != "_meta":
            assert merged[key] == measured[key]

    align = json.load(open(steps["align_steps"]["trace"]))["otherData"]
    assert steps["align_steps"]["steps"] == len(align["step_diff"]) == 20
    assert align["capture_bitwise_equal"]


def test_a_failed_step_is_recorded_and_counted(tmp_path):
    outdir = tmp_path / "fc"
    # a report left by an earlier run in the same --outdir is started afresh
    (outdir).mkdir()
    (outdir / "report.jsonl").write_text('{"step": "stale", "ok": false}\n')
    rc = first_contact.main([
        "--outdir", str(outdir), "--platform", "cpu", "--fake-devices", "4",
        "--sizes", "4K", "--smoke-size", "4K", "--verbs", "allreduce",
        "--skip-calibrate", "--skip-dryrun", "--align-algo", "nosuchalgo"])
    report = [json.loads(ln) for ln in (outdir / "report.jsonl").read_text().splitlines()]
    assert [r["step"] for r in report] == STEPS[2:]
    bad = [r for r in report if not r["ok"]]
    assert [r["step"] for r in bad] == ["align_steps"] and rc == 1
    assert "no schedule tracer" in bad[0]["error"]


def test_the_default_outdir_lies_inside_the_port_and_is_ignored():
    port = os.path.dirname(os.path.abspath(first_contact.__file__))
    assert first_contact._DEFAULT_OUTDIR == os.path.join(port, "results", "first_contact")
    ignore = open(os.path.join(os.path.dirname(port), ".gitignore")).read().split()
    assert "rocnrdma_tpu_torch/results/first_contact/" in ignore
