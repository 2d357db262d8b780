"""The port's training launcher as a user runs it, on the CPU: killed by
the fault point after its step-3 checkpoint, then ``--resume``-d, it
repeats the uninterrupted run's losses; its trace and metrics files
carry the loop's spans and series; without ``--device`` it needs the
card; and every flag of the JAX launcher it cannot honour yet exits
naming its ROADMAP item."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import train as cli
from repro_torch.train import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
FAULT_EXIT_CODE = 117       # repro_torch.train.faults.FAULT_EXIT_CODE


def _env(**extra):
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), **extra}


def _run(args, env=None, timeout=240):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, env=env or _env(),
                          timeout=timeout)


def _step_lines(stdout):
    """{step: 'loss=... xent=... acc=...'} of the per-step lines."""
    out = {}
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) > 4 and parts[0] == "step":
            out[int(parts[1])] = " ".join(parts[2:5])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch_train")
    base = ["--device", "cpu", "--reduced", "--steps", "8", "--batch", "4", "--seq", "32",
            "--n-functions", "150", "--workers", "2", "--log-every", "1",
            "--data-dir", str(tmp / "data")]
    full = _run(base + ["--trace-dir", str(tmp / "trace"),
                        "--metrics-jsonl", str(tmp / "metrics.jsonl")])
    ck = str(tmp / "ck")
    fault = {"REPRO_FAULT_PHASE": "ckpt_commit", "REPRO_FAULT_STEP": "6",
             "REPRO_FAULT_LOG": str(tmp / "kill.log")}
    killed = _run(base + ["--ckpt-dir", ck, "--ckpt-every", "3"], env=_env(**fault))
    latest_after_kill = ckpt.latest_step(ck)
    resumed = _run(base + ["--ckpt-dir", ck, "--ckpt-every", "3", "--resume"],
                   env=_env(**fault))
    return {"tmp": tmp, "full": full, "killed": killed, "resumed": resumed,
            "latest_after_kill": latest_after_kill, "ck": ck}


def test_killed_run_resumes_on_the_uninterrupted_losses(runs):
    full, killed, resumed = runs["full"], runs["killed"], runs["resumed"]
    assert full.returncode == 0 and "[done]" in full.stdout, full.stderr
    assert killed.returncode == FAULT_EXIT_CODE, killed.stderr
    assert "[done]" not in killed.stdout
    # killed after step 6's shard, before its manifest: step 3 is the newest
    assert runs["latest_after_kill"] == 3
    assert resumed.returncode == 0, resumed.stderr
    assert "[resume] host 0 restored shard at step 3" in resumed.stdout
    want, got = _step_lines(full.stdout), _step_lines(resumed.stdout)
    assert sorted(want) == list(range(1, 9)) and sorted(got) == list(range(4, 9))
    assert {s: want[s] for s in got} == got
    assert ckpt.latest_step(runs["ck"]) == 8


def test_trace_and_metrics_files_of_the_run(runs):
    assert runs["full"].returncode == 0, runs["full"].stderr
    trace = json.loads((runs["tmp"] / "trace" / "trace-0.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"step", "data_wait", "dispatch", "metrics_resolve", "metrics_drain",
            "device_block", "batch_fetch", "gather", "work_fn"} <= names
    lanes = {e["name"]: e["cat"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert lanes["step"] == "loop" and lanes["data_wait"] == "data"
    assert lanes["batch_fetch"].startswith("fetch-w")
    lines = [json.loads(x) for x in (runs["tmp"] / "metrics.jsonl").read_text().splitlines()]
    assert lines[-1]["final"] and lines[-1]["step"] == 8
    final = lines[-1]["metrics"]
    assert final["train_step_time_ms"]["count"] == 7
    assert {"train_stall_fraction", "train_tokens_per_s", "train_device_puts"} <= set(final)


def test_without_a_device_flag_it_needs_the_card():
    out = _run(["--reduced", "--steps", "1"], env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "no CUDA device" in out.stderr


REFUSALS = [([flag, "2"], item) for flag, item in cli.REFUSED_FLAGS.items()]
REFUSALS += [(["--sharding", mode], item) for mode, item in cli.SHARDING_ITEMS.items()]
REFUSALS += [(["--elastic-restore"], "A12")]


@pytest.mark.parametrize("argv,item", REFUSALS, ids=[" ".join(a) for a, _ in REFUSALS])
def test_unported_flags_exit_naming_their_item(argv, item, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    assert f"ROADMAP {item}" in capsys.readouterr().err


def test_resume_needs_a_checkpoint_dir(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--resume"])
    assert "--resume needs --ckpt-dir" in capsys.readouterr().err
