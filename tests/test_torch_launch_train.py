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
    assert final["grad_dp_size"] == 1 and final["grad_n_buckets"] == 0


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


# ---------------------------------------------------------------------------
# data parallel: the CLI in two processes on gloo, joined through a file store
# ---------------------------------------------------------------------------

DDP_TIMEOUT = 120


def _run_ranks(args, tmp, tag, world=2, env=None):
    """The CLI in ``world`` processes with the JAX package's coordinator
    variables (a file store: no port shared between parallel tests).
    Returns [(returncode, stdout, stderr)] by rank; all are killed if one
    hangs past DDP_TIMEOUT."""
    procs = []
    for rank in range(world):
        e = _env(REPRO_COORDINATOR=f"file://{tmp}/store-{tag}",
                 REPRO_NUM_PROCESSES=str(world), REPRO_PROCESS_ID=str(rank),
                 REPRO_DIST_TIMEOUT_S=str(DDP_TIMEOUT), **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *args], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            o, err = p.communicate(timeout=DDP_TIMEOUT)
            out.append((p.returncode, o, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank of {tag} hung past {DDP_TIMEOUT} s")
    return out


def _losses(stdout):
    return {s: float(v.split()[0].split("=")[1]) for s, v in _step_lines(stdout).items()}


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch_ddp")
    base = ["--device", "cpu", "--reduced", "--steps", "8", "--seq", "32",
            "--n-functions", "150", "--workers", "2", "--log-every", "1",
            "--data-dir", str(tmp / "data")]
    one = _run(base + ["--batch", "8"])
    two = _run_ranks(base + ["--batch", "4", "--grad-bucket-mb", "1"], tmp, "two")
    ck = str(tmp / "ck")
    stop = {"REPRO_FAULT_PHASE": "step", "REPRO_FAULT_STEP": "5", "REPRO_FAULT_MODE": "raise"}
    ck_args = base + ["--batch", "4", "--grad-bucket-mb", "1", "--ckpt-dir", ck,
                      "--ckpt-every", "5"]
    stopped = _run_ranks(ck_args, tmp, "stopped", env=stop)
    latest = ckpt.latest_step(ck)
    resumed = _run_ranks(ck_args + ["--resume"], tmp, "resumed")
    return {"one": one, "two": two, "stopped": stopped, "latest": latest,
            "resumed": resumed, "ck": ck}


def test_two_processes_print_the_jax_lines(ddp):
    import re

    for rank, (rc, out, err) in enumerate(ddp["two"]):
        assert rc == 0 and "[done]" in out, err[-3000:]
        assert f"[dist] torch.distributed initialized: process {rank}/2 backend=gloo" in out
        assert re.search(r"^\[plan\] mode=ddp dp_axes=\['data'\] dp_size=2 "
                         r"grad_sync=bucketed_overlap buckets=(\d+) comm=[\d.]+MB/step "
                         r"wire=[\d.]+MB/dev gather=0\.0MB$", out, re.M), out
        nb = int(re.search(r"buckets=(\d+)", out).group(1))
        assert nb > 1      # --grad-bucket-mb 1 splits the reduced model's 7.4 MB
        assert re.search(rf"^\[telemetry\] .* grad_sync=bucketed_overlap/{nb}bkt/[\d.]+MB$",
                         out, re.M), out
        assert f"[gradsync] rank={rank} all_reduces={8 * nb} per_step={nb} hooks_once=True" \
            in out
        assert f"(host {rank}/2, per-host batch 4)" in out


def test_two_processes_follow_one_process_at_the_doubled_batch(ddp):
    rc, out, err = ddp["one"].returncode, ddp["one"].stdout, ddp["one"].stderr
    assert rc == 0, err
    want = _losses(out)
    got = [_losses(o) for _, o, _ in ddp["two"]]
    assert sorted(want) == list(range(1, 9)) and sorted(got[0]) == list(range(1, 9))
    for s, v in want.items():
        assert abs(got[0][s] - v) <= 2e-4 * max(1.0, abs(v)), (s, got[0][s], v)
    assert _step_lines(ddp["two"][0][1]) == _step_lines(ddp["two"][1][1])  # replicas equal


def test_two_processes_stopped_and_resumed_repeat_their_losses(ddp):
    for rc, out, err in ddp["stopped"]:
        assert rc != 0 and "TransientWorkerError" in err and "[done]" not in out
    assert ddp["latest"] == 5
    for rank, (rc, out, err) in enumerate(ddp["resumed"]):
        assert rc == 0, err[-3000:]
        assert f"[resume] host {rank} restored shard at step 5" in out
        want, got = _step_lines(ddp["two"][rank][1]), _step_lines(out)
        assert sorted(got) == list(range(6, 9))
        assert {s: want[s] for s in got} == got
    d = ckpt.step_dir(ddp["ck"], 8)
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["process_count"] == 2
    assert sorted(os.listdir(d)) == ["manifest.json", "shard-00000.npz",
                                     "shard-00000.pipeline.json", "shard-00001.npz",
                                     "shard-00001.pipeline.json"]


def test_grad_bucket_mb_is_accepted_in_one_process(ddp):
    out = ddp["one"].stdout
    assert "[plan] mode=ddp dp_axes=[] dp_size=1 grad_sync=none buckets=0" in out
    assert "grad_sync=none/0bkt/0.0MB" in out
    assert cli.build_parser().parse_args(["--grad-bucket-mb", "0.5"]).grad_bucket_mb == 0.5
    assert "--grad-bucket-mb" not in cli.REFUSED_FLAGS
