"""Env-armed fault-injection points for crash/recovery testing.

Production fault tolerance is only as good as the failures it has
actually survived, so the training path carries explicit *fault points*
— named host-visible phases where a test can make this process die (or
throw) at an exact step:

  ``step``         in :class:`~repro_torch.train.runner.TrainLoop`, right
                   after step ``i`` is dispatched (the device may still
                   be mid-backward — the host-kill analogue of losing a
                   node during compute).
  ``ckpt_commit``  in :func:`~repro_torch.train.checkpoint.save_sharded`,
                   after this process's shard ``.npz`` is committed but
                   BEFORE the manifest commit record — the torn-
                   checkpoint window ``latest_step`` must survive.
  ``gc``           in :func:`~repro_torch.train.checkpoint.gc_checkpoints`,
                   mid-prune (manifest already removed, shards not yet)
                   — a partially-deleted directory must never be taken
                   for a complete checkpoint.

Everything is driven by environment variables so subprocess workers need
no test imports (armed by ``tests/_faults.py``):

  ``REPRO_FAULT_PHASE``  which fault point fires (unset = all disarmed).
  ``REPRO_FAULT_STEP``   only fire when the point's step matches
                         (unset/-1 = first time the phase is reached).
  ``REPRO_FAULT_MODE``   ``exit`` (default): log then ``os._exit(117)``
                         — no atexit handlers, no flushes, the closest
                         a test gets to a SIGKILL'd host.  ``raise``:
                         throw :class:`TransientWorkerError` — the
                         in-process recovery path (rollback journal).
  ``REPRO_FAULT_LOG``    append a ``phase=... step=... pid=...`` line
                         before dying, and — crucially — act as the
                         fire-ONCE marker: a restarted process with the
                         same environment must not die at the same
                         point again, so the fault only fires if this
                         file does not exist yet.

The hooks are module-level functions with an early-out on the common
path (one ``os.environ.get`` when disarmed), so production runs pay
nothing measurable.
"""
from __future__ import annotations

import os

__all__ = ["fault_point", "TransientWorkerError", "FAULT_EXIT_CODE"]

# distinctive so tests can tell an injected kill from a real crash
FAULT_EXIT_CODE = 117


class TransientWorkerError(RuntimeError):
    """An injected (or detected) transient step failure — the kind the
    in-memory rollback journal recovers from without touching disk."""


def _armed(phase: str, step) -> bool:
    want = os.environ.get("REPRO_FAULT_PHASE")
    if want != phase:
        return False
    want_step = os.environ.get("REPRO_FAULT_STEP")
    if want_step not in (None, "", "-1") and step is not None \
            and int(want_step) != int(step):
        return False
    return True


def _fire_once(phase: str, step) -> bool:
    """Append the kill-log line; False if this fault already fired (the
    log file is the once-marker, created with O_EXCL so even two racing
    processes fire at most once per log path)."""
    log = os.environ.get("REPRO_FAULT_LOG")
    if not log:
        return True  # no log configured: fire every time the spec matches
    try:
        fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    except FileExistsError:
        return False
    with os.fdopen(fd, "w") as f:
        f.write(f"phase={phase} step={step} pid={os.getpid()} "
                f"mode={os.environ.get('REPRO_FAULT_MODE', 'exit')}\n")
        f.flush()
        os.fsync(f.fileno())
    return True


def fault_point(phase: str, step=None) -> None:
    """Die (or raise) here when the environment arms this phase/step.
    A no-op — one env lookup — when disarmed."""
    if "REPRO_FAULT_PHASE" not in os.environ:
        return
    if not _armed(phase, step):
        return
    if not _fire_once(phase, step):
        return
    # mark the trace so a rollback/replay in the timeline has its cause
    # next to it (armed path only — the disarmed early-out stays one
    # env lookup with no imports)
    from repro_torch.observability import get_tracer

    get_tracer().instant("fault_injected", "loop", phase=phase,
                         step=-1 if step is None else int(step))
    if os.environ.get("REPRO_FAULT_MODE", "exit") == "raise":
        raise TransientWorkerError(
            f"injected transient fault at phase={phase} step={step}")
    os._exit(FAULT_EXIT_CODE)
